"""The Masksembles convs (row 11) on the tensor cores, on the CPU: the
three-pass TF32 arithmetic of the float kernel against the JAX package,
the fragment layout its ldmatrix addressing gives 32-bit words, and the
``_xs`` entries against JAX's vmap.

On the card ``bank_conv{,_samples,_xs}`` run
``conv_mma_kernel<TX, float, BankMask<TX>>`` in
``bayestpu_torch/csrc/masked_conv.cu``: the masked value ``f32(x) · b`` and
the f32 weights are staged as f32, each operand v is split in registers
into big = tf32(v) and small = tf32(v - big) (``cvt.rna``: to nearest, ties
away from zero, 10 stored mantissa bits), and ``mma.sync.m16n8k8`` tf32 runs
small·big, big·small and big·big, in that order, into a chunk's partial
sum; K walks 8 channels a chunk, every tap of a chunk on the tensor core
from zero, and each chunk's partial is added to the f32 total with one
rounding. No CUDA kernel runs here, so a numpy model of that arithmetic
(``three_pass_conv``; each ``mma`` rounded toward zero, which no tensor
core does worse than) is held against JAX's ``bank_conv`` and
``bank_conv_samples`` with the Pallas kernel in the interpreter, to
``CONV_RTOL`` of max|ref|, the tolerance ``chip_smoke.py`` holds the card
to: at its ragged geometries and at two block-site shapes (site 1 and
site 4, the longest K, at batch 2), with f32 and bf16 x, on the generated
bank and on one with 2.0, 0.25 and negative entries.

``bank_conv_xs`` and ``bank_conv_int8_xs`` take an x that carries the
sample axis in one launch on the card; here they run the single plain
version per sample, held against ``jax.vmap`` of JAX's
``bank_conv_inference`` and ``bank_conv_int8_inference`` over (x, index)
(its ``lax.map`` branch): f32 to 1e-5 of max|ref|, int8 bit for bit. The
card path of the wrappers is checked on ``meta`` tensors with ``_launch``
replaced by a recorder.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayestpu.kernels import mask_bank as jbank
from bayestpu.kernels import masked_conv as jmc
from bayestpu_torch.kernels import masked_conv as tmc

from port_threads import thread_budget  # noqa: F401

CONV_RTOL = 3e-5                 # chip_smoke.py's CONV_RTOL, of max|ref|
FLOAT_RTOL = 1e-5
STEPS = (2.0 ** -7, 2.0 ** -6)
CE = 8                           # f32 channels of a chunk (32 bytes)
# x NHWC, kernel size, F, padding, stride: chip_smoke.py's CONV_RAGGED,
# then block sites 1 and 4 of vgg11 at batch 2
GEOMS = {
    "same_s2": ((3, 15, 16, 40), 3, 20, "SAME", 2),
    "valid": ((2, 9, 7, 33), 3, 13, "VALID", 1),
    "explicit_s2": ((2, 9, 7, 35), 3, 11, ((2, 1), (0, 2)), 2),
    "1x1_s2": ((3, 6, 6, 36), 1, 10, "SAME", 2),
    "site1_b2": ((2, 16, 16, 64), 3, 128, "SAME", 1),
    "site4_b2": ((2, 2, 2, 512), 3, 512, "SAME", 1),
}
IDXS = np.array([2, -1, 5], np.int32)        # wrapping and negative
S = len(IDXS)


# ------------------------------------------------------ the numpy model


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """f32 rounded to tf32 as ``cvt.rna.tf32.f32`` (to nearest, ties away
    from zero), its low 13 bits cleared: on the sign-magnitude bits, add
    half of the last kept bit and truncate."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(big, small): big = tf32(a), small = tf32(a - big), as the kernel's
    ``split_tf32`` (a - big is exact in f32)."""
    big = tf32_rna(a)
    return big, tf32_rna(np.float32(a) - big)


def f32_toward_zero(v: np.ndarray) -> np.ndarray:
    """float64 values rounded to f32 toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def three_pass_conv(xm: np.ndarray, w: np.ndarray, padding, stride: int
                    ) -> np.ndarray:
    """The float bank kernel's sums: xm (N, H, W, C) the staged masked x,
    w (KH, KW, C, F) f32; (N, Ho, Wo, F) f32. K in the kernel's order
    (chunk of 8 channels, tap, channel); per chunk and tap the products
    small·big, big·small and big·big, each ``mma`` one 8-term step whose
    exact sum with the partial is rounded toward zero; each chunk's partial
    added to the total with one rounding to nearest."""
    n, h, wd, c = xm.shape
    kh, kw, _, f = w.shape
    g = tmc.geometry(h, wd, kh, kw, padding, stride)
    cp = -(-c // CE) * CE
    xp = np.pad(xm, ((0, 0), (g.ph, g.ph_hi), (g.pw, g.pw_hi), (0, cp - c)))
    wp = np.pad(w, ((0, 0), (0, 0), (0, cp - c), (0, 0)))
    (xb, xs), (wb, ws) = split_tf32(xp), split_tf32(wp)
    acc = np.zeros((n, g.ho, g.wo, f), np.float32)
    rows = slice(None, stride * (g.ho - 1) + 1, stride)
    cols = slice(None, stride * (g.wo - 1) + 1, stride)
    for c0 in range(0, cp, CE):
        part = np.zeros_like(acc)
        for t in range(kh * kw):
            i, j = divmod(t, kw)

            def tap(a):
                return a[:, i:, j:, c0:c0 + CE][:, rows, cols].astype(
                    np.float64)

            def taps(a):
                return a[i, j, c0:c0 + CE].astype(np.float64)

            for a, b in ((xs, wb), (xb, ws), (xb, wb)):
                part = f32_toward_zero(part.astype(np.float64) + np.einsum(
                    "nhwc,cf->nhwf", tap(a), taps(b)))
        acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


# ------------------------------------------------------------- helpers


def _data(name, seed=0):
    shape, k, f, _, _ = GEOMS[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(k, k, shape[-1], f))
         / np.sqrt(k * k * shape[-1])).astype(np.float32)
    bias = rng.normal(scale=0.3, size=f).astype(np.float32)
    return x, w, bias


def _bank(c, odd=False):
    """The generated (4, C) bank, or chip_smoke.py's odd one: 2.0, 0.25 and
    negative entries (a negative one reads as 0, as JAX clips it)."""
    _, bank = jbank.generation_wrapper(c, 4, 2.0, rng=0)
    bank = np.ascontiguousarray(bank, np.float32)
    if odd:
        bank[0, ::7] = 2.0
        bank[1, 1::5] = 0.25
        bank[1, :5] = -1.5
    return bank


def _x5(a, dtype=None):
    """(S, N, H, W, C) numpy → (S, N, C, H, W) torch, each sample in
    channels_last memory and the samples outermost."""
    t = torch.from_numpy(np.array(a)).permute(0, 1, 4, 2, 3)
    return t if dtype is None else t.to(dtype)


def _w(a, dtype=None):
    t = torch.from_numpy(np.array(a.transpose(3, 2, 0, 1)))
    return t if dtype is None else t.to(dtype)


def _np5(t):
    """(S, N, F, Ho, Wo) → (S, N, Ho, Wo, F) numpy."""
    t = t.detach().permute(0, 1, 3, 4, 2)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _err(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


# ------------------------------------------------------- the TF32 split


@pytest.mark.parametrize("kind", ["normal", "bf16", "wide", "ties"])
def test_split_halves_are_tf32_and_sum_to_22_bits(kind):
    """big and small are tf32 values (low 13 bits zero); big + small is v
    to 2^-22 of |v|; a bf16 value (a bf16 x or w widened) is its own big
    half, small 0; a tie rounds away from zero."""
    rng = np.random.default_rng(7)
    v = rng.normal(size=4096).astype(np.float32)
    if kind == "bf16":
        v = np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    elif kind == "wide":
        v = (v * np.float32(2.0) ** rng.integers(-60, 60, size=v.shape)
             ).astype(np.float32)
    elif kind == "ties":
        u = v.view(np.uint32) & np.uint32(0xFFFFE000) | np.uint32(0x1000)
        v = u.view(np.float32)
    big, small = split_tf32(v)
    for h in (big, small):
        assert not (h.view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs(v.astype(np.float64) - big - small)
    assert (err <= 2.0 ** -22 * np.abs(v)).all()
    if kind == "bf16":
        assert np.array_equal(big, v) and not small.any()
    if kind == "ties":
        assert (np.abs(big) > np.abs(v)).all()


# ------------------------------------------ the model against JAX


@pytest.mark.parametrize("odd", [False, True], ids=["bank", "bank_odd"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_three_pass_model_within_conv_rtol_of_jax(geom, bf16, odd):
    """The three-pass TF32 sums of the masked x, with the epilogue of the
    block-site path (the (F,) bias and relu, f32 out), within CONV_RTOL of
    JAX's ``bank_conv_samples`` at indices that wrap and a negative one,
    and of its ``bank_conv`` at one index."""
    x, w, bias = _data(geom, seed=11)
    _, _, _, padding, stride = GEOMS[geom]
    bank = _bank(x.shape[-1], odd)
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    xw = np.asarray(jx.astype(jnp.float32))          # bf16 x widened
    kw = dict(bias=jnp.asarray(bias), act="relu", stride=stride)
    want = jmc.bank_conv_samples(jx, jnp.asarray(w), jnp.asarray(bank),
                                 jnp.asarray(IDXS), padding, interpret=True,
                                 **kw)
    got = []
    for i in IDXS:
        row = np.maximum(bank[i % 4], 0.0)           # _bank_select_row
        xm = (xw.astype(np.float64) * row).astype(np.float32)
        y = three_pass_conv(xm, w, padding, stride)
        got.append(np.maximum((y.astype(np.float64) + bias).astype(
            np.float32), 0.0))
    assert _err(np.stack(got), want) <= CONV_RTOL
    one = jmc.bank_conv(jx, jnp.asarray(w), jnp.asarray(bank), -1, padding,
                        interpret=True, **kw)
    assert _err(got[1], one) <= CONV_RTOL


# ------------------------------------------------- the fragment layout

KB = 32                          # bytes of a staged row
MMA_BN = 128                     # output channels of a block


def swz(row: int, half: int) -> int:
    """``swz`` of masked_conv.cu: 16-byte half of a 32-byte row."""
    return row * KB + ((half ^ ((row >> 2) & 1)) << 4)


def ldmatrix_x4(mem: np.ndarray, addrs: list) -> np.ndarray:
    """``ldmatrix.sync.aligned.m8n8.x4.shared.b16`` on 32-bit words: lanes
    8i..8i+7 give the 16-byte rows of matrix i; lane T receives, in its
    register i, word T % 4 of row T // 4 of matrix i. (32, 4) uint32."""
    words = mem.view(np.uint32)
    out = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        for i in range(4):
            addr = addrs[8 * i + lane // 4]
            assert addr % 16 == 0
            out[lane, i] = words[addr // 4 + lane % 4]
    return out


@pytest.mark.parametrize("geom", [(8, 8, 3, 1), (4, 4, 3, 2), (2, 2, 1, 1)])
def test_ldmatrix_gives_the_tf32_fragments(geom):
    """The conv routine's ldmatrix addressing on f32 rows (8 channels of
    32 bytes, swizzled as staged) hands each lane PTX's m16n8k8 tf32
    fragments: A (16 x 8, row) a0 = A[g][t], a1 = A[g+8][t], a2 =
    A[g][t+4], a3 = A[g+8][t+4]; B (8 x 8, col) b0 = B[t][g], b1 =
    B[t+4][g], with g = lane / 4 and t = lane % 4; at every warp, tile and
    tap of a block-site tile geometry (TH x TW outputs, kernel, stride)."""
    th, tw, k, st = geom
    nb = max(1, 64 // (th * tw))
    ph, pw = (th - 1) * st + k, (tw - 1) * st + k
    rows = nb * ph * pw
    # the patch: row r, channel c holds a distinct f32, stored by
    # Patch::store (vector i: half i & 1 of row i >> 1, channels 4 (i & 1)
    # .. + 3)
    patch_val = np.arange(rows * CE, dtype=np.float32).reshape(rows, CE) + 1
    patch = np.zeros(rows * KB, np.uint8)
    for r in range(rows):
        for h in range(2):
            a = swz(r, h)
            patch[a:a + 16] = patch_val[r, 4 * h:4 * h + 4].view(np.uint8)
    # the weights of k*k taps: row t * MMA_BN + f, channel c, by
    # stage_weights (thread tid: half tid & 1 of channel tid >> 1)
    w_val = (np.arange(k * k * MMA_BN * CE, dtype=np.float32).reshape(
        k * k, MMA_BN, CE) + 0.5)
    wmem = np.zeros(k * k * MMA_BN * KB, np.uint8)
    for t in range(k * k):
        for tid in range(2 * MMA_BN):
            a = t * MMA_BN * KB + swz(tid >> 1, tid & 1)
            h = tid & 1
            wmem[a:a + 16] = w_val[t, tid >> 1, 4 * h:4 * h + 4].view(
                np.uint8)
    tpix, bm = th * tw, nb * th * tw
    lanes = np.arange(32)
    g, tg = lanes // 4, lanes % 4
    for t in range(k * k):
        toff = (t // k) * pw + t % k
        for warp in range(8):
            wm, wn = warp >> 2, warp & 3
            for mi in range(2):
                arow = []
                for lane in range(32):
                    p = wm * 32 + mi * 16 + (lane & 15)
                    nbi, ohl, owl = p // tpix, (p // tw) % th, p % tw
                    arow.append((nbi * ph + ohl * st) * pw + owl * st
                                if p < bm else 0)
                frag = ldmatrix_x4(patch, [swz(arow[lane] + toff, lane >> 4)
                                           for lane in range(32)])

                def A(m, c):
                    return patch_val[arow[m] + toff, c]
                for lane in range(32):
                    want = [A(g[lane], tg[lane]), A(g[lane] + 8, tg[lane]),
                            A(g[lane], tg[lane] + 4),
                            A(g[lane] + 8, tg[lane] + 4)]
                    assert np.array_equal(frag[lane].view(np.float32),
                                          np.float32(want))
            boff = [swz(wn * 32 + (lane >> 4) * 8 + (lane & 7),
                        (lane >> 3) & 1) for lane in range(32)]
            for nj2 in range(2):
                frag = ldmatrix_x4(wmem, [t * MMA_BN * KB + b + nj2 * 16 * KB
                                          for b in boff])
                for half in range(2):
                    nj = 2 * nj2 + half

                    def B(kk, n):
                        return w_val[t, wn * 32 + nj * 8 + n, kk]
                    for lane in range(32):
                        want = [B(tg[lane], g[lane]),
                                B(tg[lane] + 4, g[lane])]
                        got = frag[lane, 2 * half:2 * half + 2]
                        assert np.array_equal(got.view(np.float32),
                                              np.float32(want))


# ---------------------------------------------------- the _xs entries

XS_GEOMS = ["same_s2", "explicit_s2", "1x1_s2"]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", XS_GEOMS)
def test_bank_conv_xs_equals_jax_vmap(geom, bf16):
    """A float x carrying S samples (f32 or bf16, the f32 w), on the odd
    bank, with the (F,) bias and relu: ``bank_conv_xs`` and
    ``bank_conv_inference`` equal JAX's vmap over (x, index) within
    FLOAT_RTOL, with the indices as a tensor or a list; sample s
    bit-equal to ``bank_conv`` on x[s]; no launch counted on the CPU."""
    x, w, bias = _data(geom, seed=5)
    _, _, _, padding, stride = GEOMS[geom]
    x5 = np.stack([x, -0.5 * x, 2.0 * x])
    bank = _bank(x.shape[-1], odd=True)
    jx = jnp.asarray(x5, jnp.bfloat16 if bf16 else jnp.float32)
    tx = _x5(np.asarray(jx.astype(jnp.float32)),
             torch.bfloat16 if bf16 else torch.float32)
    want = jax.vmap(lambda xs, i: jmc.bank_conv_inference(
        xs, jnp.asarray(w), jnp.asarray(bank), i, padding, interpret=True,
        bias=jnp.asarray(bias), act="relu", stride=stride))(
        jx, jnp.asarray(IDXS))
    tkw = dict(bias=torch.from_numpy(bias), act="relu", stride=stride)
    tb, ti = torch.from_numpy(bank), torch.from_numpy(IDXS)
    tmc.reset_launch_counts()
    got = tmc.bank_conv_xs(tx, _w(w), tb, ti, padding, **tkw)
    assert set(tmc.launch_counts.values()) == {0}
    assert got.dtype == torch.float32 and got.shape[0] == S
    assert _err(_np5(got), want) <= FLOAT_RTOL
    for same in (tmc.bank_conv_inference(tx, _w(w), tb, ti, padding, **tkw),
                 tmc.bank_conv_xs(tx, _w(w), tb, IDXS.tolist(), padding,
                                  **tkw)):
        assert torch.equal(same, got)
    for s in range(S):
        assert torch.equal(got[s], tmc.bank_conv(
            tx[s], _w(w), tb, int(IDXS[s]), padding, **tkw))


@pytest.mark.parametrize("epi", ["affine_relu_int8", "bias_f32"])
@pytest.mark.parametrize("geom", XS_GEOMS)
def test_bank_conv_int8_xs_equals_jax_vmap(geom, epi):
    """An int8 x carrying S samples on the odd bank (binarized at 0.5):
    ``bank_conv_int8_xs`` and ``bank_conv_int8_inference`` bit-equal to
    JAX's vmap over (x_q, index), with the BN affine, relu and an int8
    store, and with an (F,) bias and an f32 store; sample s bit-equal to
    the single call."""
    shape, k, f, padding, stride = GEOMS[geom]
    rng = np.random.default_rng(9)
    x5 = rng.integers(-128, 128, size=(S,) + shape).astype(np.int8)
    wq = rng.integers(-128, 128, size=(k, k, shape[-1], f)).astype(np.int8)
    affine = np.stack([rng.uniform(0.5, 1.5, f),
                       rng.normal(scale=0.3, size=f)]).astype(np.float32)
    bank = _bank(shape[-1], odd=True)
    if epi == "affine_relu_int8":
        jkw = dict(bias=jnp.asarray(affine), act="relu", out_step=STEPS[0])
        tkw = dict(bias=torch.from_numpy(affine), act="relu",
                   out_step=STEPS[0])
    else:
        jkw = dict(bias=jnp.asarray(affine[1]))
        tkw = dict(bias=torch.from_numpy(affine[1]))
    want = np.asarray(jax.vmap(lambda xs, i: jmc.bank_conv_int8_inference(
        xs, jnp.asarray(wq), jnp.asarray(bank), i, *STEPS, padding,
        interpret=True, stride=stride, **jkw))(
        jnp.asarray(x5), jnp.asarray(IDXS)))
    tb, ti = torch.from_numpy(bank), torch.from_numpy(IDXS)
    tmc.reset_launch_counts()
    got = tmc.bank_conv_int8_xs(_x5(x5), _w(wq), tb, ti, *STEPS, padding,
                                stride=stride, **tkw)
    assert set(tmc.launch_counts.values()) == {0}
    assert got.dtype == (torch.int8 if "int8" in epi else torch.float32)
    np.testing.assert_array_equal(_np5(got), want)
    assert torch.equal(tmc.bank_conv_int8_inference(
        _x5(x5), _w(wq), tb, ti, *STEPS, padding, stride=stride, **tkw), got)
    for s in range(S):
        assert torch.equal(got[s], tmc.bank_conv_int8(
            _x5(x5)[s], _w(wq), tb, int(IDXS[s]), *STEPS, padding,
            stride=stride, **tkw))


def test_xs_guards():
    """What the bank _xs entries refuse: an index count other than S, and a
    sample axis whose samples are not outermost in channels_last
    memory."""
    x, w, _ = _data("same_s2")
    x5 = np.stack([x, x, x])
    tb = torch.from_numpy(_bank(x.shape[-1]))
    with pytest.raises(ValueError, match="carries"):
        tmc.bank_conv_xs(_x5(x5), _w(w), tb, torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="carries"):
        tmc.bank_conv_int8_inference(
            _x5(x5).to(torch.int8), _w(w).to(torch.int8), tb, [0, 1],
            *STEPS)
    nchw = torch.from_numpy(x5).permute(0, 1, 4, 2, 3).contiguous()
    with pytest.raises(ValueError, match="channels_last"):
        tmc.bank_conv_xs(nchw, _w(w), tb, torch.from_numpy(IDXS))


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_xs_card_path_is_one_launch(monkeypatch, int8):
    """On a tensor off the CPU (``meta`` here, with the device check of
    ``_check`` mapped to the CPU) a 5-D Masksembles site makes ONE launch
    of ``bt_bank_conv{,_int8}_xs`` for the S samples, counted under the
    entry's own name, with the bank, the int32 indices on x's device and
    num_masks."""
    calls = []
    monkeypatch.setattr(tmc, "_launch", lambda entry, counter, x, w, head,
                        num_samples, *rest: calls.append(
                            (entry, counter, tuple(x.shape), num_samples,
                             head)) or torch.empty(0))
    real = tmc._check
    monkeypatch.setattr(tmc, "_check", lambda x, w, q: real(
        torch.empty(x.shape, dtype=x.dtype).contiguous(
            memory_format=torch.channels_last),
        torch.empty(w.shape, dtype=w.dtype), q))
    dt = torch.int8 if int8 else torch.bfloat16
    x5 = torch.empty((S, 2, 5, 6, 16), dtype=dt, device="meta").permute(
        0, 1, 4, 2, 3)
    w = torch.empty((8, 16, 3, 3), dtype=torch.int8 if int8
                    else torch.float32, device="meta")
    bank = torch.empty((4, 16), device="meta")
    idxs = torch.empty(S, dtype=torch.int64, device="meta")
    if int8:
        tmc.bank_conv_int8_inference(x5, w, bank, idxs, *STEPS)
    else:
        tmc.bank_conv_inference(x5, w, bank, idxs)
    assert len(calls) == 1
    entry, counter, shape, num_samples, head = calls[0]
    name = "bank_conv_int8_xs" if int8 else "bank_conv_xs"
    assert (entry, counter, shape, num_samples) == (name, name,
                                                    tuple(x5.shape), S)
    assert head[0] is bank and head[2] == 4
    assert head[1].dtype == torch.int32 and head[1].device == x5.device
    assert head[1].shape == (S,)
