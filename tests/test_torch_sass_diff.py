"""The SASS comparison's parsers on a hand-written ``cuobjdump`` listing
(the comparison itself needs nvcc and runs on the card's machine)."""

from basicrta_torch.scripts import sass_diff as sd

SASS = """
Fatbin elf code:
================
arch = sm_90a

\tcode for sm_90a
\t\tFunction : _Z3onePf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
                                                                     /* 0x000fe20000000800 */
.L_x_0:
        /*0010*/                   BRA `(.L_x_0);                    /* 0xfffffffc00fc7947 */
\t\t..........

\t\tFunction : _ZN40_GLOBAL__N__1635691d_8_sweep_cu_aaed38e83twoPf
        /*0000*/                   EXIT ;                            /* 0x000000000000794d */
"""

USAGE = """
Resource usage:
 Common:
  GLOBAL:0
 Function _Z3onePf:
  REG:55 STACK:136 SHARED:0 LOCAL:0 CONSTANT[0]:364 TEXTURE:0
 Function _ZN40_GLOBAL__N__1635691d_8_sweep_cu_aaed38e83twoPf:
  REG:8 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:360 TEXTURE:0
"""


def test_parse_sass_and_usage():
    kernels = sd.parse_sass(SASS)
    two = "_ZN40_GLOBAL__N__8_sweep_cu_aaed38e83twoPf"  # path hash out
    assert kernels == {"_Z3onePf": ["LDC R1, c[0x0][0x28]", ".L_x_0",
                                    "BRA `(.L_x_0)"],
                       two: ["EXIT"]}
    assert sd.parse_usage(USAGE) == {"_Z3onePf": (55, 136), two: (8, 0)}


def test_compare_counts_changed_lines():
    a = (sd.parse_sass(SASS), sd.parse_usage(USAGE))
    changed = SASS.replace("LDC R1", "LDC R2").replace("1635691d", "f4a48b05")
    b = (sd.parse_sass(changed), sd.parse_usage(USAGE))
    rows = {r["kernel"]: r for r in sd.compare(a, b)}
    two = rows["_ZN40_GLOBAL__N__8_sweep_cu_aaed38e83twoPf"]
    assert two["identical"] and two["changed"] == 0
    one = rows["_Z3onePf"]
    assert not one["identical"] and one["changed"] == 2
    assert one["instructions"] == [3, 3] and one["reg"] == [55, 55]
    assert one["stack"] == [136, 136]
