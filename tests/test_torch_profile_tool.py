"""``veles_tpu_torch/tools/flash_bwd_profile.py``'s SASS reading, on the
CPU: the LRN report's opcode classes, widths, loops and common-path walk
on a synthetic ``cuobjdump -sass`` listing (the tool itself runs only on
the card, where the listing comes from the built library), and its
refusal to run without a card."""

import types

import pytest
import torch

from veles_tpu_torch.ops import _build
from veles_tpu_torch.tools import flash_bwd_profile as P

#: a per-quad loop at 0x10..0x90 with powf's special-case chain: the
#: d == 1 branch falls through, the d >= 0 exit (a predicate set by
#: FSETP.GEU against RZ, two instructions earlier) is taken
LISTING = """
        Function : _ZN12_GLOBAL__N_114lrn_fwd_kernelILi5ELi4EEEvPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x0 */
        /*0010*/                   LDS.128 R4, [R2] ;       /* 0x0 */
        /*0020*/                   FSETP.NEU.AND P2, PT, R8, 1, PT ; /* 0x0 */
        /*0030*/              @!P2 BRA 0x80 ;               /* 0x0 */
        /*0040*/                   FSETP.GEU.AND P0, PT, R8, RZ, PT ; /* 0x0 */
        /*0050*/                   MOV R29, R31 ;           /* 0x0 */
        /*0060*/               @P0 BRA 0x80 ;               /* 0x0 */
        /*0070*/                   FRND.FLOOR R9, R10 ;     /* 0x0 */
        /*0080*/                   STG.E.EF.128 desc[UR16][R2.64], R4 ;  /* 0 */
        /*0090*/               @!P1 BRA 0x10 ;              /* 0x0 */
        /*00a0*/                   MUFU.RCP R9, R9 ;        /* 0x0 */
        /*00b0*/                   UBLKCP.S.G [UR14], [UR34], UR13 ; /* 0x0 */
        /*00c0*/                   EXIT ;                   /* 0x0 */
        Function : _Z16flash_fwd_kernelPKf
        /*0000*/                   EXIT ;                   /* 0x0 */
"""


@pytest.fixture
def listing(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(P, "demangle", lambda s: "lrn_fwd_kernel<5, 4>")
    monkeypatch.setattr(P.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=LISTING))


def test_lrn_sass_counts_classes_and_widths(listing):
    (name, rec), = P.lrn_sass("lib.so").items()
    assert name == "lrn_fwd_kernel<5, 4>"
    assert rec["total"] == 13
    assert rec["classes"]["mufu"] == 1 and rec["classes"]["bulk_copy"] == 1
    assert rec["classes"]["lds"] == 1 and rec["classes"]["stg"] == 1
    assert rec["classes"]["fp32"] == 3 and rec["classes"]["branch"] == 4
    assert rec["widths"] == {"LDS.128": 1, "STG.E.EF.128": 1,
                             "UBLKCP.S.G": 1}


def test_lrn_sass_walks_the_common_path(listing):
    rec = P.lrn_sass("lib.so")["lrn_fwd_kernel<5, 4>"]
    # [first, last, instructions, common path, stores on it]: the path
    # skips the special case at 0x70 (8 of the loop's 9 instructions)
    assert rec["loops"] == [[0x10, 0x90, 9, 8, 1]]


def test_lrn_sass_writes_listings(listing, tmp_path):
    P.lrn_sass("lib.so", tmp_path)
    (path,) = tmp_path.iterdir()
    assert path.name == "lrn_fwd_kernel_5_4_.sass"
    assert "UBLKCP.S.G" in path.read_text()


def test_profile_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert P.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_sass_mix_counts_the_flash_kernels(listing):
    assert P.sass_mix("lib.so") == {"flash_fwd_kernel": {"EXIT": 1}}
