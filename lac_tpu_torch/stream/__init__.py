"""The .lac container (``lac_tpu``'s exports of
``lac_tpu/stream/__init__.py``)."""

from .container import BlockEntry, ContainerHeader, read_container, write_container  # noqa: F401
