"""The port's build helpers that need no compiler: the SASS loop finder of
lac_tpu_torch.ops._build, on listings written out by hand in the form
``_sass_functions`` parses (address, opcode, text)."""

import pytest

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


_NVCC_NS = "_GLOBAL__N__4c0d71_14_o12n_rans32_cu_a4f4f290"


@pytest.mark.parametrize("ns", [f"_ZN{len(_NVCC_NS)}{_NVCC_NS}", "_ZN12_GLOBAL__N_1"],
                         ids=["nvcc", "host"])
def test_kernel_label_comes_from_the_mangled_symbol(ns):
    """Labels come from the mangled symbol itself, past its anonymous
    namespace (nvcc's names the source and a hash; the host compiler's is
    ``_GLOBAL__N_1``): a template's arguments are all kept, so that the
    nibble template's instances stay distinct, and a kernel of another tree
    (the one-thread order1n kernel, order2n's before its template, or the
    template over lo contexts alone) gets its own name too."""
    for mangled, label in (
            (f"{ns}20nib_intervals_kernelILi1ELi16EEEvPKhiiiPiS3_",
             "nib_intervals_kernel<1, 16>"),
            (f"{ns}17nib_decode_kernelILi16ELi16EEEvPKtPKiiiiiPh", "nib_decode_kernel<16, 16>"),
            (f"{ns}17nib_decode_kernelILi16ELi64EEEvPKtPKiiiiiPh", "nib_decode_kernel<16, 64>"),
            (f"{ns}21o12n_intervals_kernelILi16EEEvPKhiiiPiS3_", "o12n_intervals_kernel<16>"),
            (f"{ns}18o12n_decode_kernelILi64EEEvPKtPKiiiiiPh", "o12n_decode_kernel<64>"),
            (f"{ns}20ctx_intervals_kernelILi16EEEvPKhiiiPiS3_", "ctx_intervals_kernel<16>"),
            (f"{ns}20o2n_intervals_kernelEPKhiiiPiS2_", "o2n_intervals_kernel"),
            (f"{ns}27causal_attn_fwd_sm90_kernelILi128EEEv14CUtensorMap_st",
             "causal_attn_fwd_sm90_kernel<128>"),
            ("_Z17o0n_decode_kernelPKt", "o0n_decode_kernel"),
            ("no_kernel_here", "no_kernel_here")):
        assert _build._kernel_label(mangled) == label
