"""The C interface of the port's CUDA sources against the ctypes
declarations that call it, on the CPU.

Every ``extern "C" int bt_*`` of ``bayestpu_torch/csrc/*.cu`` is parsed
(its macros expanded) and held against ``_build._SIGNATURES``: one entry
per function, of the same arity and the same kinds (a pointer ``c_void_p``,
``int`` ``c_int``, ``uint32_t`` ``c_uint32``, ``float`` ``c_float``,
``const int*`` ``POINTER(c_int)``). A wrong argtype cuts a pointer or an
int silently on the card, where no test of this machine reaches. Also the
layouts the conv wrapper hands the kernels (``conv_weights``) and its
choice of routine by dtypes (``tensor_core``), which the C side mirrors.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from bayestpu_torch.kernels import _build
from bayestpu_torch.kernels import masked_conv as tmc

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
KINDS = {"int": ctypes.c_int, "uint32_t": ctypes.c_uint32,
         "float": ctypes.c_float}


def _macros(src: str) -> dict:
    """``#define NAME body`` with its continuation lines joined."""
    out = {}
    for m in re.finditer(r"^#define\s+(\w+)\s+((?:.*\\\n)*.*)$", src, re.M):
        out[m.group(1)] = m.group(2).replace("\\\n", " ")
    return out


def _entries(src: str) -> dict:
    """name -> parameter list of every ``extern "C" int bt_*``."""
    macros = _macros(src)
    out = {}
    for m in re.finditer(r'extern\s+"C"\s+int\s+(bt_\w+)\s*\(([^)]*)\)',
                         src):
        params = m.group(2)
        for name, body in macros.items():
            params = re.sub(rf"\b{name}\b", body, params)
        out[m.group(1)] = [p.strip() for p in params.split(",") if p.strip()]
    return out


def _kind(param: str):
    """The ctypes type a C parameter needs."""
    decl = re.sub(r"\s+", " ", param.replace("*", " * ")).strip()
    words = decl.split()
    if "*" in words:
        base = [w for w in words[:words.index("*")] if w != "const"]
        return (ctypes.POINTER(ctypes.c_int) if base == ["int"]
                else ctypes.c_void_p)
    base = [w for w in words[:-1] if w != "const"]
    assert len(base) == 1 and base[0] in KINDS, param
    return KINDS[base[0]]


def _all_entries() -> list:
    return [(src.stem, name, params)
            for src in sorted(CSRC.glob("*.cu"))
            for name, params in _entries(src.read_text()).items()]


ENTRIES = _all_entries()


def test_every_source_has_entries():
    assert sorted(_build.sources()) == sorted(_build._SIGNATURES)
    assert {src for src, _, _ in ENTRIES} == set(_build._SIGNATURES)
    assert len(ENTRIES) >= 15


@pytest.mark.parametrize("src,name,params", ENTRIES,
                         ids=[n for _, n, _ in ENTRIES])
def test_argtypes_match_the_c_signature(src, name, params):
    declared = _build._SIGNATURES[src].get(name)
    assert declared is not None, f"{name} of {src}.cu has no argtypes"
    want = [_kind(p) for p in params]
    assert len(declared) == len(want), (name, len(declared), len(want))
    for i, (got, kind) in enumerate(zip(declared, want)):
        assert got is kind, f"{name} argument {i} ({params[i]}): {got} " \
                            f"declared, {kind} needed"


def test_every_declared_function_exists():
    have = {(src, name) for src, name, _ in ENTRIES}
    for src, table in _build._SIGNATURES.items():
        for name in table:
            assert (src, name) in have, f"{name} is not in {src}.cu"


def test_parser_reads_pointer_and_scalar_kinds():
    assert _kind("const void* x") is ctypes.c_void_p
    assert _kind("void *stream") is ctypes.c_void_p
    assert _kind("const int *dims") is ctypes.POINTER(ctypes.c_int)
    assert _kind("uint32_t thresh") is ctypes.c_uint32
    assert _kind("float fscale") is ctypes.c_float
    assert _kind("int idx") is ctypes.c_int


@pytest.mark.parametrize("dtype,staged,ce", [
    (torch.bfloat16, None, 16), (torch.int8, None, 32),
    (torch.float32, None, None), (torch.bfloat16, torch.float32, 8),
    (torch.float32, torch.float32, 8)])
def test_conv_weight_layouts(dtype, staged, ce):
    """The OIHW kernel as each routine reads it: (KH·KW, F, Cp) with C
    zero-padded to 32 bytes of the staged type for the tensor-core one (8
    f32 channels for the float bank convs, a bf16 w widened exactly),
    (KH, KW, C, F) for the CUDA-core one."""
    g = torch.Generator().manual_seed(0)
    w = torch.randint(-100, 100, (5, 35, 3, 2), generator=g).to(dtype)
    if ce is None:
        wk = tmc.conv_weights(w, False)
        assert torch.equal(wk, w.permute(2, 3, 1, 0))
        return
    wk = tmc.conv_weights(w, True, staged)
    assert wk.dtype == (staged or dtype)
    cp = -(-35 // ce) * ce
    assert wk.shape == (6, 5, cp) and wk.is_contiguous()
    for kh in range(3):
        for kw in range(2):
            assert torch.equal(wk[kh * 2 + kw, :, :35],
                               w[:, :, kh, kw].to(wk.dtype))
    assert not wk[:, :, 35:].any()


def test_routine_follows_the_dtypes():
    bf, f32, i8 = (torch.empty(1, dtype=d) for d in
                   (torch.bfloat16, torch.float32, torch.int8))
    assert tmc.tensor_core("masked_conv", bf, bf)
    assert tmc.tensor_core("masked_conv_xs", bf, bf)
    assert tmc.tensor_core("masked_conv_int8", i8, i8)
    assert tmc.tensor_core("masked_conv_int8_xs", i8, i8)
    assert not tmc.tensor_core("masked_conv", f32, f32)
    assert not tmc.tensor_core("masked_conv", bf, f32)
    assert not tmc.tensor_core("masked_conv", f32, bf)
    # every bank entry: int8 on the s8 tensor cores, float (whatever the
    # dtypes) as three TF32 products of w in f32
    for x, w in ((bf, f32), (f32, f32), (bf, bf), (f32, bf)):
        for entry in ("bank_conv", "bank_conv_samples", "bank_conv_xs"):
            assert tmc.tensor_core(entry, x, w)
            assert tmc.staged_dtype(entry, w) == torch.float32
    for entry in ("bank_conv_int8", "bank_conv_int8_samples",
                  "bank_conv_int8_xs"):
        assert tmc.tensor_core(entry, i8, i8)
        assert tmc.staged_dtype(entry, i8) == torch.int8
    for w in (bf, f32, i8):
        assert tmc.staged_dtype("masked_conv", w) == w.dtype
