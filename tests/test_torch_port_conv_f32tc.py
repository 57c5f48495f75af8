"""Row 10's f32 and mixed-type MC convs on the tensor cores, on the CPU: a
numpy model of the route's arithmetic against the JAX package.

On the card every float MC conv with an f32 operand (f32 x and w, bf16 x
with f32 w, f32 x with bf16 w) runs ``conv_mma_kernel<TX, float,
HashMask<TX> or NoMask<TX>>`` of ``bayestpu_torch/csrc/masked_conv.cu``,
the float bank convs' route: the kept x is ``x · scale`` rounded to x's
type (bf16: the scale itself rounded to bf16, 1.3359375 at rate 0.25: the
bf16 trap), widened exactly to f32 and staged; a bf16 w is widened exactly;
each operand is split into big and small TF32 halves and the tensor core
runs three products a k step, summed a chunk of 8 channels at a time and
added to the f32 total with one rounding. No CUDA kernel runs here, so
``three_pass_conv`` of ``tests/test_torch_port_bank_tc.py``, applied to
the hash-masked input (``_hash_masked``, whose bits equal JAX's), is held
against JAX's ``dropout_conv``, ``dropout_conv_samples``, the vmapped
``dropout_conv_inference`` (x carrying the sample axis) and ``conv_fused``
with the Pallas kernels in the interpreter, to FLOAT_RTOL of max|ref|, at
the ragged geometries of ``test_torch_port_conv.py`` and a 7×7 window at
stride 2 (whose 8×8 tile patch, 21×21, needs the smaller tile of
``make_mma_geom``). The port's CPU path (the plain versions) is held to JAX
there too. Each JAX call costs about a second in the interpreter, so the
cases rotate the type mixes over the geometries and entries.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayestpu.kernels import masked_conv as jmc
from bayestpu_torch.kernels import masked_conv as tmc
from bayestpu_torch.kernels import masked_matmul as tmm
from port_threads import thread_budget  # noqa: F401
from test_torch_port_bank_tc import split_tf32, three_pass_conv

RATE = 0.25
FLOAT_RTOL = 1e-5
SEEDS = np.array([[-123456789, -7], [5, 99]], np.int32)   # one negative
# x NHWC, kernel size, F, padding, stride (test_torch_port_conv.py's, and a
# 7x7 window at stride 2)
GEOMS = {
    "same_s1": ((2, 6, 5, 33), 3, 13, "SAME", 1),
    "same_s2": ((2, 8, 8, 34), 3, 12, "SAME", 2),
    "explicit_s2": ((2, 9, 7, 35), 3, 11, ((2, 1), (0, 2)), 2),
    "valid": ((2, 7, 6, 32), 3, 9, "VALID", 1),
    "1x1_s2": ((3, 6, 6, 36), 1, 10, "SAME", 2),
    "7x7_s2": ((1, 10, 9, 9), 7, 16, "SAME", 2),
}
# (x bf16, w bf16): the three pairs that take the f32 route
MIXES = {"f32": (False, False), "bf16x": (True, False),
         "bf16w": (False, True)}
# (entry, geometry, mix): every geometry and every entry under more than
# one mix, the 7x7 window under all three
CASES = [
    ("samples", "same_s1", "f32"), ("samples", "same_s2", "bf16x"),
    ("samples", "explicit_s2", "bf16w"), ("samples", "1x1_s2", "f32"),
    ("samples", "7x7_s2", "f32"), ("samples", "7x7_s2", "bf16x"),
    ("single", "same_s1", "bf16w"), ("single", "valid", "bf16x"),
    ("single", "7x7_s2", "bf16w"),
    ("xs", "same_s2", "f32"), ("xs", "explicit_s2", "bf16x"),
    ("xs", "1x1_s2", "bf16w"),
    ("fused", "same_s1", "bf16x"), ("fused", "valid", "f32"),
    ("fused", "1x1_s2", "bf16w"),
]


def _data(geom, bf16x, bf16w, seed=3):
    """x (f32 or bf16-valued), w HWIO, the (2, F) affine, from a seed; x
    and w as JAX arrays of the mix's dtypes and as the port's tensors."""
    shape, k, f, _, _ = GEOMS[geom]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(k, k, shape[-1], f))
         / np.sqrt(k * k * shape[-1])).astype(np.float32)
    affine = np.stack([rng.uniform(0.5, 1.5, f),
                       rng.normal(scale=0.3, size=f)]).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if bf16x else jnp.float32)
    jw = jnp.asarray(w, jnp.bfloat16 if bf16w else jnp.float32)
    return jx, jw, affine, _tx(jx), _tw(jw)


def _tx(jx):
    """An NHWC JAX array (4-D, or 5-D with the sample axis first) as the
    port's x in its dtype: NCHW in channels_last memory."""
    a = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    t = a.permute(0, 3, 1, 2) if a.dim() == 4 else a.permute(0, 1, 4, 2, 3)
    return t.to(torch.bfloat16 if jx.dtype == jnp.bfloat16 else t.dtype)


def _tw(jw):
    t = torch.from_numpy(np.asarray(jw.astype(jnp.float32)).transpose(
        3, 2, 0, 1).copy())
    return t.bfloat16() if jw.dtype == jnp.bfloat16 else t


def _nhwc(t):
    """A port result (4-D, or 5-D with samples) → NHWC numpy f32."""
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4
            else t.permute(0, 1, 3, 4, 2)).numpy()


def _err(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def route(tx, tw, seeds, geom, scale=None):
    """The f32 route's sums of one sample: x masked as the kernel stages it
    (``_hash_masked``: a kept value ``x · scale`` in x's dtype; ``seeds``
    None: no mask; ``scale`` overrides the dtype's), widened to f32, and
    the three-pass TF32 sums with the f32 w. (N, Ho, Wo, F) f32."""
    _, _, _, padding, stride = GEOMS[geom]
    if seeds is None:
        xm = tx
    elif scale is None:
        xm = tmc._hash_masked(tx, torch.from_numpy(seeds), RATE)
    else:
        keep = tmc.keep_mask_nchw(torch.from_numpy(seeds), tx, RATE)
        xm = torch.where(keep, (tx.float() * scale).to(tx.dtype), 0)
    x = xm.float().permute(0, 2, 3, 1).numpy()
    w = tw.float().permute(2, 3, 1, 0).numpy()
    return three_pass_conv(x, w, padding, stride)


def epilogue(y, affine=None, bias=None, relu=False):
    """``fma(acc, scale, bias)`` (the f64 product is exact) or ``acc +
    bias``, then relu, in f32."""
    y = y.astype(np.float64)
    if affine is not None:
        y = y * affine[0] + affine[1]
    elif bias is not None:
        y = y + bias
    y = y.astype(np.float32)
    return np.maximum(y, 0.0) if relu else y


@pytest.mark.parametrize("entry,geom,mix", CASES,
                         ids=["-".join(c) for c in CASES])
def test_three_pass_route_within_rtol_of_jax(entry, geom, mix):
    """The f32 route's arithmetic (the three-pass model on the hash-masked
    x, then the entry's epilogue) within FLOAT_RTOL of max|ref| of JAX's
    entry in the interpreter; the port's own CPU path too."""
    jx, jw, affine, tx, tw = _data(geom, *MIXES[mix])
    _, _, _, padding, stride = GEOMS[geom]
    ta = torch.from_numpy(affine)
    if entry == "samples":
        want = jmc.dropout_conv_samples(
            jx, jw, jnp.asarray(SEEDS), RATE, padding, interpret=True,
            bias=jnp.asarray(affine), act="relu", stride=stride)
        model = np.stack([epilogue(route(tx, tw, sd, geom), affine,
                                   relu=True) for sd in SEEDS])
        port = tmc.dropout_conv_samples(tx, tw, torch.from_numpy(SEEDS),
                                        RATE, padding, bias=ta, act="relu",
                                        stride=stride)
        if mix == "bf16x":
            # the bf16 trap: x · 1.3333334 rounded to bf16 once, instead of
            # x · 1.3359375 (the scale rounded to bf16 first), misses JAX
            # by far more than the tolerance
            assert tmm.scale_of(RATE, torch.bfloat16) == 1.3359375
            off = epilogue(route(tx, tw, SEEDS[0], geom, 1.0 / 0.75),
                           affine, relu=True)
            assert _err(off, want[0]) > 10 * FLOAT_RTOL
    elif entry == "single":
        want = jmc.dropout_conv(jx, jw, jnp.asarray(SEEDS[1]), RATE,
                                padding, interpret=True, stride=stride)
        model = route(tx, tw, SEEDS[1], geom)
        port = tmc.dropout_conv(tx, tw, torch.from_numpy(SEEDS[1]), RATE,
                                padding, stride)
    elif entry == "xs":
        x5 = jnp.stack([jx, (-0.5 * jx).astype(jx.dtype)])
        want = jax.vmap(lambda xs, sd: jmc.dropout_conv_inference(
            xs, jw, sd, RATE, padding, interpret=True,
            bias=jnp.asarray(affine[1]), act="relu", stride=stride))(
            x5, jnp.asarray(SEEDS))
        t5 = _tx(x5)
        model = np.stack([epilogue(route(t5[s], tw, SEEDS[s], geom),
                                   bias=affine[1], relu=True)
                          for s in range(len(SEEDS))])
        port = tmc.dropout_conv_inference(t5, tw, torch.from_numpy(SEEDS),
                                          RATE, padding, bias=ta[1],
                                          act="relu", stride=stride)
    else:
        want = jmc.conv_fused(jx, jw, bias=jnp.asarray(affine), act="relu",
                              padding=padding, interpret=True, stride=stride)
        model = epilogue(route(tx, tw, None, geom), affine, relu=True)
        port = tmc.conv_fused(tx, tw, bias=ta, act="relu", padding=padding,
                              stride=stride)
    assert port.dtype == torch.float32
    assert _err(model, want) <= FLOAT_RTOL
    assert _err(_nhwc(port), want) <= FLOAT_RTOL


def test_bf16_operand_halves():
    """Where one operand is bf16 its small TF32 half is zero, so one of the
    three products adds nothing: a bf16 value (a bf16 x masked and
    widened, or a bf16 w widened) is its own big half."""
    jx, jw, _, tx, tw = _data("same_s1", True, True)
    xm = tmc._hash_masked(tx, torch.from_numpy(SEEDS[0]), RATE).float()
    for a in (xm.numpy(), tw.float().numpy()):
        big, small = split_tf32(a)
        assert np.array_equal(big, a) and not small.any()


# -------------------------------------------------------- the tile bound


def _constants() -> dict:
    src = (Path(tmc.__file__).resolve().parent.parent / "csrc"
           / "masked_conv.cu").read_text()
    return {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (\w+) = ([^;]+);", src)}


def _tile(ho, wo, n, k, st, rows):
    """``make_mma_geom``'s tile (NB, TH, TW) of masked_conv.cu, in
    Python, or None where it refuses."""
    th, tw = min(ho, 8), min(wo, 8)
    nb = min(64 // (th * tw), n)

    def patch():
        return nb * ((th - 1) * st + k) * ((tw - 1) * st + k)
    while patch() > rows and nb > 1:
        nb = (nb + 1) // 2
    while patch() > rows and (th > 1 or tw > 1):
        if th >= tw:
            th = (th + 1) // 2
        else:
            tw = (tw + 1) // 2
    return (nb, th, tw) if patch() <= rows else None


def test_window_bound_names_the_kernel_limit():
    """``MAX_WINDOW_TAPS`` is the kernel's patch limit (MAXV vectors of 16
    bytes a thread, two a row); the tile (the C geometry, mirrored) fits
    every window up to it at stride 1 and 2 on any input, a 7x7 window at
    stride 2 included, and keeps its 8x8-and-NB tile wherever that fit
    before the tile could shrink; a larger window is refused by name."""
    c = _constants()
    rows = int(c["MAXV"]) * int(c["MMA_THREADS"]) // 2
    assert c["MAX_PATCH_ROWS"] == "MAXV * MMA_THREADS / 2"
    assert tmc.MAX_WINDOW_TAPS == rows == 384
    for k in (1, 3, 5, 7, 11, 19):
        for st in (1, 2):
            for ho in (1, 3, 8, 16, 57):
                for n in (1, 4):
                    nb, th, tw = _tile(ho, ho + 1, n, k, st, rows)
                    assert nb * ((th - 1) * st + k) * (
                        (tw - 1) * st + k) <= rows
                    t8, w8 = min(ho, 8), min(ho + 1, 8)
                    if ((t8 - 1) * st + k) * ((w8 - 1) * st + k) <= rows:
                        assert (th, tw) == (t8, w8)
    assert _tile(16, 16, 8, 7, 2, rows)[1:] == (4, 8)
    assert _tile(1, 1, 1, 20, 1, rows) is None
    x = torch.zeros(1, 4, 24, 24).contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="MAX_WINDOW_TAPS = 384"):
        tmc.dropout_conv(x, torch.zeros(2, 4, 20, 20),
                         torch.tensor([1, 2], dtype=torch.int32), RATE)
    with pytest.raises(ValueError, match="MAX_WINDOW_TAPS"):
        tmc.conv_int8_fused(x.to(torch.int8),
                            torch.zeros(2, 4, 1, 385, dtype=torch.int8),
                            1.0, 1.0)
