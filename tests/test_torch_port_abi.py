"""The C interface of the port's CUDA sources against the ctypes
declarations that call it, on the CPU.

Every ``extern "C" int bt_*`` of ``bayestpu_torch/csrc/*.cu`` is parsed
(its macros expanded) and held against ``_build._SIGNATURES``: one entry
per function, of the same arity and the same kinds (a pointer ``c_void_p``,
``int`` ``c_int``, ``uint32_t`` ``c_uint32``, ``float`` ``c_float``,
``const int*`` ``POINTER(c_int)``). A wrong argtype cuts a pointer or an
int silently on the card, where no test of this machine reaches. Also the
layout the conv wrapper hands the kernels (``conv_weights``) and the type
it stages by dtypes (``staged_dtype``), which the C side mirrors.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from bayestpu_torch.kernels import _build
from bayestpu_torch.kernels import masked_conv as tmc

from port_threads import thread_budget  # noqa: F401

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
    (torch.float32, None, 8), (torch.bfloat16, torch.float32, 8),
    (torch.float32, torch.float32, 8)])
def test_conv_weight_layouts(dtype, staged, ce):
    """The OIHW kernel as the conv kernels read it: (KH·KW, F, Cp) with C
    zero-padded to 32 bytes of the staged type (16 bf16, 32 int8 or 8 f32
    channels; an f32 w in its own type, a bf16 w widened exactly for the
    f32 route)."""
    g = torch.Generator().manual_seed(0)
    w = torch.randint(-100, 100, (5, 35, 3, 2), generator=g).to(dtype)
    wk = tmc.conv_weights(w, staged)
    assert wk.dtype == (staged or dtype)
    cp = -(-35 // ce) * ce
    assert wk.shape == (6, 5, cp) and wk.is_contiguous()
    for kh in range(3):
        for kw in range(2):
            assert torch.equal(wk[kh * 2 + kw, :, :35],
                               w[:, :, kh, kw].to(wk.dtype))
    assert not wk[:, :, 35:].any()


def test_routine_follows_the_dtypes():
    """Every entry runs the tensor-core routine; the dtypes pick the type
    it stages and multiplies in, as ``launch_float`` and ``bank_conv`` of
    masked_conv.cu pick its instantiation: bf16 only for an MC conv of
    bf16 x and w, int8 for int8, f32 (three TF32 products) for every other
    float pair, MC or bank."""
    bf, f32, i8 = (torch.empty(1, dtype=d) for d in
                   (torch.bfloat16, torch.float32, torch.int8))
    for entry in ("masked_conv", "masked_conv_xs"):
        assert tmc.staged_dtype(entry, bf, bf) == torch.bfloat16
        for x, w in ((f32, f32), (bf, f32), (f32, bf)):
            assert tmc.staged_dtype(entry, x, w) == torch.float32
    for entry in ("masked_conv_int8", "masked_conv_int8_xs"):
        assert tmc.staged_dtype(entry, i8, i8) == torch.int8
    # every float bank entry, whatever the dtypes: three TF32 products of
    # w in f32; int8 on the s8 tensor cores
    for x, w in ((bf, f32), (f32, f32), (bf, bf), (f32, bf)):
        for entry in ("bank_conv", "bank_conv_samples", "bank_conv_xs"):
            assert tmc.staged_dtype(entry, x, w) == torch.float32
    for entry in ("bank_conv_int8", "bank_conv_int8_samples",
                  "bank_conv_int8_xs"):
        assert tmc.staged_dtype(entry, i8, i8) == torch.int8
    # the C side: an f32 operand takes the f32 route, only bf16 x with bf16
    # w the bf16 one, and no CUDA-core routine is left
    src = (CSRC / "masked_conv.cu").read_text()
    assert "launch_mma<B, float>(x, w, make(MaskT<B>{})" in src
    assert "launch_mma<float, float>(x, w, make(MaskT<float>{})" in src
    assert "conv_kernel<" not in src.replace("conv_mma_kernel<", "")


MC_MATMUL = ("bt_dropout_matmul", "bt_dropout_matmul_samples",
             "bt_dropout_apply", "bt_dropout_matmul_int8",
             "bt_dropout_matmul_int8_samples")


@pytest.mark.parametrize("name", MC_MATMUL)
def test_mc_entries_take_row0(name):
    """Every hash-keyed matmul entry takes ``uint32_t row0`` (the global row
    of x's first row) just before the stream, declared ``c_uint32``; the
    bank entries, whose masks ignore the row, take none."""
    params = dict((n, p) for _, n, p in ENTRIES)[name]
    assert params[-2].split() == ["uint32_t", "row0"]
    assert _build._SIGNATURES["masked_matmul"][name][-2] is ctypes.c_uint32
    for bank in ("bt_bank_matmul", "bt_bank_matmul_samples"):
        assert not any("row0" in p for p in dict(
            (n, p) for _, n, p in ENTRIES)[bank])


def test_conv_dims_carry_row0():
    """The conv entries read row0 from ``dims[13]`` into the MC mask, as
    the uint32 of the int32 the wrapper stores there; the wrapper stores
    ``image_row0``'s value, wrapping past 2^31 into a negative int32."""
    src = (CSRC / "masked_conv.cu").read_text()
    assert src.count("static_cast<uint32_t>(dims[13])") == 2
    r0 = tmc.image_row0(2 ** 20, 64, 64)        # 2^32: wraps to 0
    assert r0 == 0 and tmc.image_row0(3, 16, 16) == 768
    big = tmc.image_row0(2 ** 19 + 1, 64, 64)   # past 2^31
    assert big == 2 ** 31 + 4096
    for v in (0, 768, big, 2 ** 32 - 1, 2 ** 32 + 5):
        bits = tmc.int32_bits(v)
        assert -(2 ** 31) <= bits < 2 ** 31
        assert ctypes.c_uint32(ctypes.c_int(bits).value).value == v % 2 ** 32
