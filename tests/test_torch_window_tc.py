"""A CPU mirror of the tensor-core bodies of B1 and B7, and the kernels on
the card held against it.

``csrc/window_attention.cu`` runs the products on the tensor cores with f32
sums.  In f32 each product is three TF32 products (3xTF32), on ``wgmma``
in B1's body for windows up to 8 and on ``mma.sync`` m16n8k8 in B7's and
in B1's for windows 9-12.  The mirror below takes that arithmetic in f32
on the CPU: cvt.rna rounding to TF32 on the bit pattern, hi/lo splits, the
three products of each k8 step in the kernels' order, the logits starting
at the bias, query rows padded to 16 and keys to 8 (padded keys at -inf,
padded value rows zero), the TPU op's padded keys in B7's denominator, and
the output scaled by 1 / denominator after P.V.  B1's bf16 body for
windows up to 8 takes other arithmetic (``_tc_attend_bf16``): q k^T of the
bf16 values with f32 sums, scaled by hd^-1/2 and biased afterwards, and
P.V as P_hi.V + P_lo.V with P split into two bf16 values, one k16 step of
keys at a time.

The mirror documents the arithmetic; on the CPU it checks nothing of the
kernel.  ``tests/test_torch_kernels.py`` holds it against the JAX package's
Pallas kernels (and shows one TF32 product missing them); the ``cuda``
cases here hold the kernels against it on the same inputs, so that a body
that drifts from the mirror shows on the card.  CPU cases also check B1's
16-byte row pieces (the kernel's offset arithmetic) at every Swin-T stage
width, in f32 and bf16, and a mirror of its walk over tiles (one CTA an
SM, each consumer on every NC-th tile of its CTA's run, advanced by
carries): every (image, window, head) taken once, every pixel written
once, each ring stage filled for one consumer in order.  This file imports
no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import window_attention as twa
from repro_torch.models import swin as SW

# the kernel against the mirror: the same products in the same k8 steps;
# the MMA sums its eight products with its own rounding, not the CPU's, and
# that error grows with w2 and hd.  One TF32 product missing (1e-3 and more,
# tests/test_torch_kernels.py) is thousands of ulps.
MIRROR_ULPS = 128
F32_EPS = 2.0 ** -23
# bf16: the kernel and the mirror round the same f32 result once, sums in
# other orders: one bf16 step of a row's max apart at most
BF16_STEP = 2.0 ** -7


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1fff).view(torch.float32)


def _mm_tf32(acc, a, b, products):
    """acc + a @ b in k8 steps, each as the kernel's MMAs on one accumulator:
    a_lo.b_hi, a_hi.b_lo, a_hi.b_hi (products=3) or a_hi.b_hi alone (1)."""
    for k0 in range(0, a.shape[-1], 8):
        ah, bh = _tf32(a[..., k0:k0 + 8]), _tf32(b[..., k0:k0 + 8, :])
        if products == 3:
            acc = acc + _tf32(a[..., k0:k0 + 8] - ah) @ bh
            acc = acc + ah @ _tf32(b[..., k0:k0 + 8, :] - bh)
        acc = acc + ah @ bh
    return acc


def _tc_attend(q, k, v, bias, mask, pad_keys, products=3):
    """The kernels' per-window body: q, k, v (N, nh, w2, hd) f32, bias (nh,
    w2, w2), mask (N, w2, w2) bool or None.  Returns (N, nh, w2, hd)."""
    N, nh, w2, hd = q.shape
    mp, kp = -(-w2 // 16) * 16, -(-w2 // 8) * 8
    qs = torch.zeros((N, nh, mp, hd))
    qs[:, :, :w2] = q * torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    ks, vs = torch.zeros((N, nh, kp, hd)), torch.zeros((N, nh, kp, hd))
    ks[:, :, :w2], vs[:, :, :w2] = k, v
    s = torch.zeros((N, nh, mp, kp))
    s[:, :, :w2, :w2] = bias                    # S starts at the bias
    s = _mm_tf32(s, qs, ks.transpose(-1, -2), products)
    if mask is not None:
        s[:, :, :w2, :w2] = s[:, :, :w2, :w2].masked_fill(~mask[:, None],
                                                          twa.NEG_INF)
    s[..., w2:] = -torch.inf                    # padded keys weigh exactly 0
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(-1, keepdim=True)
    if pad_keys:
        den = den + pad_keys * torch.exp(twa.NEG_INF - m)
    o = _mm_tf32(torch.zeros((N, nh, mp, hd)), e, vs, products) * (1.0 / den)
    return o[:, :, :w2]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tc_attend_bf16(q, k, v, bias, mask):
    """B1's bf16 body for windows up to 8: q, k, v (N, nh, w2, hd) f32
    holding bf16 values, bias (nh, w2, w2), mask (N, w2, w2) bool or None.
    S = q k^T (each product exact in f32, f32 sums), then S hd^-1/2 + bias;
    the masked softmax in f32; O = sum over k16 steps of keys of P_hi.V +
    P_lo.V, P_hi = bf16(P) and P_lo = bf16(P - P_hi); O / denominator,
    rounded to bf16.  Returns (N, nh, w2, hd) f32 holding bf16 values."""
    w2, hd = q.shape[-2:]
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    s = (q @ k.transpose(-1, -2)) * scale + bias
    if mask is not None:
        s = s.masked_fill(~mask[:, None], twa.NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    den = e.sum(-1, keepdim=True)
    e_hi = _bf16(e)
    e_lo = _bf16(e - e_hi)
    o = torch.zeros(q.shape)
    for k0 in range(0, w2, 16):
        vk = v[..., k0:k0 + 16, :]
        o = o + e_hi[..., k0:k0 + 16] @ vk
        o = o + e_lo[..., k0:k0 + 16] @ vk
    return _bf16(o * (1.0 / den))


def _b1_mirror(qkv, bias, mask, *, window, shift, nh, products=3,
               dtype="float32"):
    """B1 on the CPU with the bodies above: roll, partition, attend,
    un-partition, roll back.  qkv (B, Hp, Wp, 3C) numpy; returns numpy.
    dtype "bfloat16": qkv rounded to bf16 first, then the bf16 body for
    windows up to 8 and the f32 body rounded once for 9-12, as the kernel
    routes them."""
    x = torch.from_numpy(qkv)
    if dtype == "bfloat16":
        x = _bf16(x)
    B, Hp, Wp, C3 = x.shape
    hd, w2 = C3 // 3 // nh, window * window
    nwh, nww = Hp // window, Wp // window
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    x = x.reshape(B, nwh, window, nww, window, 3, nh, hd)
    x = x.permute(0, 1, 3, 5, 6, 2, 4, 7).reshape(B * nwh * nww, 3, nh, w2, hd)
    m = None
    if mask is not None:
        m = torch.from_numpy(mask).repeat(B, 1, 1)
    if dtype == "bfloat16" and window <= twa.WGMMA_MAX_WINDOW:
        o = _tc_attend_bf16(x[:, 0], x[:, 1], x[:, 2], torch.from_numpy(bias), m)
    else:
        o = _tc_attend(x[:, 0], x[:, 1], x[:, 2], torch.from_numpy(bias), m,
                       0, products)
        if dtype == "bfloat16":
            o = _bf16(o)
    o = o.reshape(B, nwh, nww, nh, window, window, hd)
    o = o.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Hp, Wp, nh * hd)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    return o.numpy()


def _b7_mirror(q, k, v, bias, mask, products=3):
    """B7 on the CPU with the body above, (nB, w2, nh, hd) numpy in and out."""
    t = [torch.from_numpy(x).permute(0, 2, 1, 3) for x in (q, k, v)]
    o = _tc_attend(*t, torch.from_numpy(bias),
                   None if mask is None else torch.from_numpy(mask),
                   twa.padded_keys(q.shape[1]), products)
    return o.permute(0, 2, 1, 3).numpy()


def _ulps_of_row_max(out, ref):
    """max |out - ref| over each output row, in f32 ulps of that row's
    max |ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max(-1, keepdims=True) * F32_EPS
    return float((np.abs(out - ref) / scale).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window,shift,hd", [(7, 3, 32), (7, 0, 16),
                                             (9, 4, 32)])
def test_b1_kernel_matches_the_mirror(cuda, window, shift, hd):
    """B1 on the card within MIRROR_ULPS of each row's max of the mirror on
    the same inputs (shifted mask where shifted)."""
    rng = np.random.default_rng(window + shift + hd)
    nh, w2 = 2, window * window
    Hp, Wp = 2 * window, 3 * window
    qkv = rng.normal(size=(2, Hp, Wp, 3 * nh * hd)).astype(np.float32)
    bias = rng.normal(size=(nh, w2, w2)).astype(np.float32)
    mask = (np.asarray(SW.shift_attn_mask(Hp, Wp, window, shift))
            if shift else None)
    exp = _b1_mirror(qkv, bias, mask, window=window, shift=shift, nh=nh)
    out = twa.fused_window_attention_cuda(
        torch.from_numpy(qkv).to(cuda), torch.from_numpy(bias).to(cuda),
        None if mask is None else torch.from_numpy(mask).to(cuda),
        window=window, shift=shift, n_heads=nh)
    assert _ulps_of_row_max(out.cpu().numpy(), exp) <= MIRROR_ULPS


def _card_b1(cuda, qkv, bias, mask, dtype, **kw):
    """B1 on the card on the mirror's inputs, as f32 numpy."""
    out = twa.fused_window_attention_cuda(
        torch.from_numpy(qkv).to(cuda, getattr(torch, dtype)),
        torch.from_numpy(bias).to(cuda),
        None if mask is None else torch.from_numpy(mask).to(cuda), **kw)
    assert str(out.dtype) == f"torch.{dtype}"
    return out.float().cpu().numpy()


def _assert_near_mirror(out, exp, dtype, hd):
    """f32 within MIRROR_ULPS of each row's max; bf16 within one bf16 step
    of each head's row max (both round the same f32 value once)."""
    if dtype == "float32":
        assert _ulps_of_row_max(out, exp) <= MIRROR_ULPS
        return
    rows = lambda x: x.reshape(x.shape[:-1] + (-1, hd))
    d = np.abs(rows(out) - rows(exp)).max(-1)
    assert (d <= BF16_STEP * np.abs(rows(exp)).max(-1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("many", [False, True], ids=["few_tiles", "many_tiles"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("window", [4, 7, 8])
def test_b1_wgmma_body_matches_the_mirror(cuda, window, hd, dtype, many):
    """B1's wgmma body (windows up to 8) on the card against the mirror on
    the same inputs, shifted and masked: windows that wrap take cp.async
    rows, the others TMA boxes.  ``many``: 3 x 4 x 156 tiles, over twice
    what one pass of the card's CTAs, consumers and ring stages holds (132
    x 3 x 2), so every consumer takes many tiles, each ring wraps round and
    runs cross from one head to the next (the bias reloaded)."""
    rng = np.random.default_rng(10 * window + hd + 1000 * many)
    w2, shift = window * window, window // 2
    B, nh, Hp, Wp = ((4, 3, 12 * window, 13 * window) if many
                     else (2, 2, 2 * window, 3 * window))
    qkv = rng.normal(size=(B, Hp, Wp, 3 * nh * hd)).astype(np.float32)
    bias = rng.normal(size=(nh, w2, w2)).astype(np.float32)
    mask = np.asarray(SW.shift_attn_mask(Hp, Wp, window, shift))
    kw = dict(window=window, shift=shift, n_heads=nh)
    exp = _b1_mirror(qkv, bias, mask, window=window, shift=shift, nh=nh,
                     dtype=dtype)
    _assert_near_mirror(_card_b1(cuda, qkv, bias, mask, dtype, **kw), exp,
                        dtype, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b1_one_tile_matches_the_mirror(cuda, dtype):
    """A call of one tile (one window, one head, one image): one CTA."""
    rng = np.random.default_rng(3)
    qkv = rng.normal(size=(1, 7, 7, 96)).astype(np.float32)
    bias = rng.normal(size=(1, 49, 49)).astype(np.float32)
    exp = _b1_mirror(qkv, bias, None, window=7, shift=0, nh=1, dtype=dtype)
    out = _card_b1(cuda, qkv, bias, None, dtype, window=7, shift=0, n_heads=1)
    _assert_near_mirror(out, exp, dtype, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("w2,hd", [(49, 32), (81, 64), (144, 128)])
def test_b7_kernel_matches_the_mirror(cuda, w2, hd):
    """B7 in f32 on the card within MIRROR_ULPS of each row's max of the
    mirror on the same inputs, masked, with two fully masked rows."""
    rng = np.random.default_rng(w2 + hd)
    nB, nh = 4, 2
    q, k, v = (rng.normal(size=(nB, w2, nh, hd)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(nh, w2, w2)).astype(np.float32)
    mask = (rng.random((nB, w2, w2)) < 0.7) | np.eye(w2, dtype=bool)[None]
    mask[1, [0, w2 - 1]] = False
    exp = _b7_mirror(q, k, v, bias, mask)
    out = twa.window_attention_cuda(
        *(torch.from_numpy(x).to(cuda) for x in (q, k, v, bias, mask)))
    assert _ulps_of_row_max(out.cpu().numpy(), exp) <= MIRROR_ULPS


def _swin_stages():
    from repro_torch.configs.swin_t_detection import CONFIG, reduced
    return [(cfg.stage_dim(s), cfg.num_heads[s])
            for cfg in (reduced(), CONFIG) for s in range(cfg.n_stages)]


@pytest.mark.parametrize("C,nh", _swin_stages())
def test_b1_row_pieces_are_16_byte_aligned(C, nh):
    """B1 moves each head's slice of a pixel in 16-byte pieces (4 f32 or 8
    bf16 values) with cp.async and 16-byte stores: at every Swin-T stage
    width, reduced and full, each piece it gathers from qkv (B, Hp, Wp, 3C)
    (q, k at +C, v at +2C) and each it stores into out (B, Hp, Wp, C) starts
    at a multiple of 16 bytes, as the kernel computes the offsets."""
    hd = C // nh
    assert C % nh == 0 and hd in twa.SUPPORTED_HEAD_DIMS
    for esize in (4, 2):
        elems = 16 // esize
        pieces = np.arange(hd // elems) * elems
        for pix in (0, 1, 7, 12345):
            for h in range(nh):
                for part in (0, C, 2 * C):
                    assert ((pix * 3 * C + part + h * hd + pieces) * esize
                            % 16 == 0).all()
                assert ((pix * C + h * hd + pieces) * esize % 16 == 0).all()


# -- the walk of B1's wgmma kernel over tiles --------------------------------

SMS = 132                      # the H100's SMs: one CTA each
RING = 2                       # stages of each consumer's ring (kWgRing)


def _b1_grid(tiles):
    """The kernel's CTAs: one an SM, no more CTAs than tiles."""
    return min(tiles, SMS)


class _TileWalk:
    """The kernel's TileWalk: a tile's (head, image, window row, window
    column), the head slowest, found by division at the start and advanced
    by carries."""

    def __init__(self, tile, B, nwh, nww):
        per_head = B * nwh * nww
        self.h, rest = divmod(tile, per_head)
        self.b = rest // (nwh * nww)
        self.wr = rest % (nwh * nww) // nww
        self.wc = rest % nww

    def advance(self, n, B, nwh, nww):
        self.wc += n
        while self.wc >= nww:
            self.wc -= nww
            self.wr += 1
            if self.wr == nwh:
                self.wr = 0
                self.b += 1
                if self.b == B:
                    self.b = 0
                    self.h += 1


def _b1_walk(B, Hp, Wp, window, shift, nh, consumers):
    """A mirror of fused_window_attention_wgmma_kernel's index arithmetic.
    CTA c of min(T, SMS) takes the run of tiles [c T / grid, (c + 1) T /
    grid); its consumer cw takes the run's tiles cw, cw + consumers, ...,
    its TileWalk started at the first and advanced by `consumers`.  Yields,
    for each CTA, one list a consumer of (tile, i, h, b, win, box, pixels,
    stage, phase): i the tile's place in the run, box whether TMA loads it
    (its window does not wrap), pixels (row, col) of its w2 tokens (the
    box's rows and columns in order, or (row0 + i) % Hp, (col0 + j) % Wp
    token by token for cp.async), stage and phase its ring stage and the
    fill of that stage it is."""
    nwh, nww = Hp // window, Wp // window
    tiles = nh * B * nwh * nww
    grid = _b1_grid(tiles)
    for c in range(grid):
        t_begin, t_end = c * tiles // grid, (c + 1) * tiles // grid
        cta = []
        for cw in range(consumers):
            at = _TileWalk(t_begin + cw, B, nwh, nww)
            mine = []
            for tile in range(t_begin + cw, t_end, consumers):
                i = tile - t_begin
                row0, col0 = at.wr * window + shift, at.wc * window + shift
                box = row0 + window <= Hp and col0 + window <= Wp
                if box:
                    pix = [(row0 + r, col0 + q) for r in range(window)
                           for q in range(window)]
                else:
                    pix = [((row0 + t // window) % Hp,
                            (col0 + t % window) % Wp)
                           for t in range(window * window)]
                stage, phase = _b1_ring_stage(i, consumers, RING)
                mine.append((tile, i, at.h, at.b, at.wr * nww + at.wc, box,
                             pix, stage, phase))
                at.advance(consumers, B, nwh, nww)
            cta.append(mine)
        yield cta


def _b1_mask_pieces(win, w2, nW):
    """The kernel's 16-byte cp.async pieces of window win's mask bytes:
    (address, bytes read), from the 16-byte boundary at or before them."""
    at0 = win * w2 * w2
    a0 = at0 & ~15
    pieces = (at0 + w2 * w2 - a0 + 15) // 16
    return [(a0 + 16 * p, min(16, nW * w2 * w2 - a0 - 16 * p))
            for p in range(pieces)]


def _swin_stage_maps():
    from repro_torch.configs.swin_t_detection import CONFIG as cfg
    out = []
    for s in range(cfg.n_stages):
        H, W = cfg.stage_hw(s)
        w = cfg.window
        out.append((-(-H // w) * w, -(-W // w) * w, cfg.num_heads[s], w))
    return out


@pytest.mark.parametrize("consumers", [2, 3])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("stage", range(4))
def test_b1_walk_covers_every_tile_and_pixel_once(stage, B, shift, consumers):
    """At each Swin-T stage map, batch 1 and 4, shift 0 and 3, 2 and 3
    consumers a CTA (f32's and bf16's): the walk by carries names the tile
    that division does; every (image, window, head) is one consumer's tile
    exactly once; every pixel of every image is one token of one tile of
    each head exactly once; a box's pixels are the modular ones; the runs
    differ in length by one at most and each holds as few heads as its
    length allows; a run's consumers take every consumers-th tile in turn,
    each stage's fills go to one consumer with phases 0, 1, 2, ...; and
    every SM has a CTA."""
    Hp, Wp, nh, window = _swin_stage_maps()[stage]
    nW = (Hp // window) * (Wp // window)
    tiles = nh * B * nW
    seen, pixels, lengths = set(), {}, set()
    ctas = list(_b1_walk(B, Hp, Wp, window, shift, nh, consumers))
    assert len(ctas) == min(tiles, SMS)
    for cta in ctas:
        run = sorted(x for mine in cta for x in mine)
        lengths.add(len(run))
        assert [x[1] for x in run] == list(range(len(run)))
        assert len({x[2] for x in run}) <= 1 + -(-len(run) // (B * nW))
        fills = {}
        for cw, mine in enumerate(cta):
            assert [x[1] for x in mine] == list(range(cw, len(run), consumers))
            for _, _, _, _, _, _, _, st, phase in mine:
                fills.setdefault(st, []).append((cw, phase))
        for st, seq in fills.items():
            assert len({cw for cw, _ in seq}) == 1
            assert [ph for _, ph in seq] == list(range(len(seq)))
        for tile, _, h, b, win, box, pix, _, _ in run:
            assert (h, b, win) == (tile // (B * nW), tile % (B * nW) // nW,
                                   tile % nW)
            assert (h, b, win) not in seen
            seen.add((h, b, win))
            if box:
                row0 = (win // (Wp // window)) * window + shift
                col0 = (win % (Wp // window)) * window + shift
                assert pix == [((row0 + t // window) % Hp,
                                (col0 + t % window) % Wp)
                               for t in range(window * window)]
            for r, c in pix:
                pixels[(h, b, r, c)] = pixels.get((h, b, r, c), 0) + 1
    assert len(seen) == tiles
    assert max(lengths) - min(lengths) <= 1
    assert len(pixels) == nh * B * Hp * Wp and set(pixels.values()) == {1}
    assert any(not x[5] for cta in ctas for mine in cta for x in mine) == (
        shift > 0)


def test_b1_walk_of_a_call_with_fewer_tiles_than_sms():
    """4 tiles: 4 CTAs of one tile each, taken by consumer 0 (the others
    idle), each wrapped window by cp.async."""
    B, Hp, Wp, window, shift, nh = 1, 7, 14, 7, 3, 2
    assert _b1_grid(nh * B * 2) == 4
    ctas = list(_b1_walk(B, Hp, Wp, window, shift, nh, 3))
    assert [[len(m) for m in cta] for cta in ctas] == [[1, 0, 0]] * 4
    assert {(x[2], x[4]) for cta in ctas for x in cta[0]} == {
        (0, 0), (0, 1), (1, 0), (1, 1)}
    assert not any(x[5] for cta in ctas for x in cta[0])


@pytest.mark.parametrize("stage", range(4))
def test_b1_mask_pieces_cover_each_window_and_stay_in_the_tensor(stage):
    """Each window's mask bytes lie in its 16-byte pieces, which start at
    16-byte boundaries, fit the stage's mask room (w2^2 + 32 bytes) and
    read nothing past the (nW, w2, w2) tensor."""
    Hp, Wp, _, window = _swin_stage_maps()[stage]
    w2, nW = window * window, (Hp // window) * (Wp // window)
    for win in range(nW):
        pieces = _b1_mask_pieces(win, w2, nW)
        a0 = pieces[0][0]
        assert a0 % 16 == 0 and a0 <= win * w2 * w2 < a0 + 16
        assert 16 * len(pieces) <= w2 * w2 + 32
        end = max(at + n for at, n in pieces)
        assert end >= (win + 1) * w2 * w2 and end <= nW * w2 * w2
        assert all(0 < n <= 16 for _, n in pieces)


def _b1_ring_stage(i, consumers, ring):
    """The kernel's stage of a run's tile i: consumer i % consumers, its own
    ring of `ring` stages; and the fill of that stage it is (its phase)."""
    k = i // consumers
    return i % consumers + consumers * (k % ring), k // ring


@pytest.mark.parametrize("consumers,ring", [(3, 1), (3, 3), (2, 2), (1, 3),
                                            (2, 5)])
def test_b1_ring_gives_each_stage_one_consumer_in_order(consumers, ring):
    """Every stage's fills go to one consumer, which takes them one after
    another: so a consumer's wait by parity is always for the fill after
    the last one it took, never one two phases ahead of the barrier."""
    fills = {}
    for i in range(60):
        st, phase = _b1_ring_stage(i, consumers, ring)
        assert 0 <= st < consumers * ring
        fills.setdefault(st, []).append((i % consumers, phase, i))
    assert len(fills) == consumers * ring
    for st, seq in fills.items():
        assert {c for c, _, _ in seq} == {st % consumers}
        assert [ph for _, ph, _ in seq] == list(range(len(seq)))
        tiles = [i for _, _, i in seq]
        assert all(b - a == consumers * ring for a, b in zip(tiles, tiles[1:]))
