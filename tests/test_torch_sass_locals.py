"""skred_tpu_torch.tools.sass_locals' reading of an ``nvdisasm -g``
listing, on a listing written out here (no CUDA toolkit needed)."""

from skred_tpu_torch.tools.sass_locals import local_accesses

LISTING = """
.text._Z1kv:
\t//## File "/src/k.cu", line 10
        /*0000*/                   STL.64 [R1], R4 ;
.L_x_1:
\t//## File "/src/k.cu", line 12
        /*0010*/                   LDL.64 R52, [R1] ;
.L_x_2:
\t//## File "/src/k.cu", line 14
        /*0020*/                   FADD R5, R2, R3 ;
        /*0030*/              @!P0 BRA `(.L_x_2) ;
        /*0040*/              @!P1 BRA `(.L_x_1) ;
        /*0050*/                @P0 LDL R3, [R1+0x4] ;
        /*0060*/                   EXIT ;
.text._Z1jv:
        /*0000*/                   FADD R5, R2, R3 ;
.L_x_3:
        /*0010*/                   STL [R1+0x8], R5 ;
        /*0020*/                   BRA `(.L_x_3) ;
"""


def test_local_accesses_with_their_lines_and_loops():
    found = local_accesses(LISTING)
    assert [(f, a, w, t.split()[0]) for f, a, w, t, _ in found] == [
        ("_Z1kv", 0x00, "k.cu:10", "STL.64"),
        ("_Z1kv", 0x10, "k.cu:12", "LDL.64"),
        ("_Z1kv", 0x50, "k.cu:14", "@P0"),
        ("_Z1jv", 0x10, "", "STL"),
    ]
    # the outer loop (0x10-0x40) holds the second access, not the inner
    # one (0x20-0x30); addresses restart in each function
    assert [s for *_, s in found] == [[], [4], [], [2]]


def test_a_listing_without_local_memory_has_nothing():
    text = LISTING.replace("STL", "STG").replace("LDL", "LDG")
    assert local_accesses(text) == []
