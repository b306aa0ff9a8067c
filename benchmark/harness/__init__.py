"""The benchmark harness: manifest, weights, spans, trace, counts, checks
and the run itself. Everything particular to a cell, a configuration, a
traffic mix or a metric lives in files of its own beside this package."""
