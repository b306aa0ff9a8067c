"""The port's build helpers that need no compiler: the SASS loop finder of
lac_tpu_torch.ops._build, on listings written out by hand in the form
``_sass_functions`` parses (address, opcode, text)."""

from lac_tpu_torch.ops import _build


def _listing(*ops):
    return [(16 * i, op.split()[0].split(".")[0], op) for i, op in enumerate(ops)]


def test_innermost_loop_is_the_largest_loop_that_holds_no_other():
    """A kernel with a set-up loop (a table's stores), then a step loop
    nested in a block loop: the step loop, not the shorter set-up loop and
    not the loop around it. The branch to itself after EXIT is no loop."""
    ins = _listing("MOV R1", "STS [R1]", "BRA 0x10",        # set-up loop 0x10-0x20
                   "IADD3 R2", "LDS R3", "LOP3 R4", "IMAD R5",
                   "SHFL.IDX R6", "BRA 0x40",                # step loop 0x40-0x80
                   "STG [R2]", "BRA 0x30",                   # block loop 0x30-0xa0
                   "EXIT", "BRA 0xb0")
    loop = _build._innermost_loop(ins)
    assert [i[0] for i in loop] == [0x40, 0x50, 0x60, 0x70, 0x80]
    counts = {op: sum(1 for i in loop if i[1] == op) for op in ("LDS", "SHFL", "STS")}
    assert counts == {"LDS": 1, "SHFL": 1, "STS": 0}


def test_innermost_loop_skips_a_jump_back_past_exit():
    """A divergent slow path after EXIT that jumps back into the loop body
    spans an EXIT, so it is no loop; without a loop the result is empty."""
    ins = _listing("IADD3 R1", "LDS R2", "BRA 0x0", "EXIT", "MOV R3", "BRA 0x10")
    assert [i[0] for i in _build._innermost_loop(ins)] == [0x0, 0x10, 0x20]
    assert _build._innermost_loop(_listing("MOV R1", "EXIT", "BRA 0x20")) == []
