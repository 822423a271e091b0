"""The decomposition of the codec kernels (``csrc/codec.cu``), mirrored on the
CPU and held bitwise against the JAX package's Pallas kernels.

A CUDA kernel cannot run here, so this file mirrors, in torch integer ops,
how the kernels split the work: one CTA of 8 warps per quantisation block;
the block's 128-lane rows in chunks of up to 64, each chunk cut into 8
contiguous strips of at most 8 rows, one per warp; four lanes of a row
packed into one 32-bit word per thread, with per-byte (mod 256) addition and
subtraction on the words.

  encode: the absmax over every warp's strips, then the quantised rows; the
          delta against the row above comes from the same strip, from the
          warp above through shared memory (its last row), or, for a
          chunk's first strip, from the previous chunk's last row quantised
          again.  Row 0 of a block stays absolute.
  decode: a per-byte running sum down each strip, each warp's column totals
          through shared memory, and the sum of the totals of the warps
          above and of the earlier chunks added to every row.

The quant pair (B4a/B4b) runs the same bodies without the delta on a leaf
of n values that is not padded: blocks wholly inside the leaf are the
encode's and decode's; the last block's strips cover only the rows that
hold values, the row that straddles n is read and written lane by lane
(zero past n), and quant writes the rows past n as zero words.

The mirror, the port's plain versions and the Pallas kernels (interpret
mode, as ``tests/test_torch_kernels.py`` runs them) must give the same
stream bytes, scale bits and decoded floats.  Inputs are the adversarial
blocks of ``repro_torch.kernels.codec.codec_edge_blocks``, made with numpy
from a seed (the card-only tests and ``chip_smoke.py`` check the kernels on
the same blocks); its last block has a subnormal scale, which the JAX package on
the CPU flushes to 0, so it is held against the plain version only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import codec as jcodec
from repro.kernels import quant as jquant
from repro_torch.kernels import codec as tcodec
from repro_torch.kernels import quant as tquant

LANES = 128
WARPS = 8               # warps of a CTA
STRIP = 8               # rows a warp holds in registers
CHUNK = WARPS * STRIP   # rows of a chunk
HIGH = 0x80808080
LOW = 0x7F7F7F7F
WORD = 0xFFFFFFFF
BLOCKS = [128, 256, 1024, 8192, 49152]
RAGGED = [8320, 128 * 193]     # a last chunk of one row, of 1 of 64
QUANT_BLOCKS = [128, 8192, 8320, 65536]
# leaf lengths of the quant pair; "split-1 leaf" is a narrow leaf of the
# split-1 payload's layout (1, H, W, 96)
QUANT_LENGTHS = {"1": lambda b: 1, "127": lambda b: 127, "128": lambda b: 128,
                 "129": lambda b: 129, "block-1": lambda b: b - 1,
                 "block+1": lambda b: b + 1,
                 "3block+4321": lambda b: 3 * b + 4321}
SPLIT1_LEAF = (1, 17, 25, 96)


def strip_of(chunk: int, rows: int, warp: int):
    """(first row, rows) of warp ``warp``'s strip in chunk ``chunk``."""
    row0 = chunk * CHUNK
    rows_c = min(CHUNK, rows - row0)
    per = -(-rows_c // WARPS)
    lo = warp * per
    return row0 + lo, max(0, min(per, rows_c - lo))


def n_chunks(rows: int) -> int:
    return -(-rows // CHUNK)


def vadd4(a, b):
    """Per-byte a + b mod 256 on 32-bit words (CUDA's __vadd4)."""
    return (((a & LOW) + (b & LOW)) ^ ((a ^ b) & HIGH)) & WORD


def vsub4(a, b):
    """Per-byte a - b mod 256 on 32-bit words (CUDA's __vsub4)."""
    return (((a | HIGH) - (b & LOW)) ^ ((a ^ ~b) & HIGH)) & WORD


def to_words(b):
    """(..., 128) bytes in 0..255 -> (..., 32) words, column 4l in the low
    byte of word l (a little-endian 32-bit load)."""
    b = b.reshape(*b.shape[:-1], LANES // 4, 4).to(torch.int64)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def to_bytes(w):
    """Inverse of ``to_words``: (..., 32) words -> (..., 128) bytes."""
    b = torch.stack([(w >> (8 * k)) & 0xFF for k in range(4)], dim=-1)
    return b.reshape(*w.shape[:-1], LANES)


def encode_mirror(flat: torch.Tensor, block: int, delta: bool):
    """flat (nb * block,) f32 -> (stream, scales), as the encode kernel
    computes them."""
    nb, rows = flat.shape[0] // block, block // LANES
    x = flat.reshape(nb, rows, LANES)
    warp_max = torch.zeros((nb, WARPS))
    for c in range(n_chunks(rows)):
        for w in range(WARPS):
            first, n = strip_of(c, rows, w)
            if n:
                m = x[:, first:first + n].abs().amax(dim=(1, 2))
                warp_max[:, w] = torch.maximum(warp_max[:, w], m)
    absmax = warp_max.amax(dim=1)
    inv = torch.tensor(tcodec.INV_INT8_MAX, dtype=torch.float32)
    scale = torch.where(absmax > 0, absmax * inv, torch.ones_like(absmax))

    def quant4(rows_x):                      # (nb, n, 128) f32 -> (nb, n, 32)
        q = torch.clamp(torch.round(rows_x / scale[:, None, None]), -127, 127)
        return to_words(q.to(torch.int64) & 0xFF)

    out = torch.zeros((nb, rows, LANES // 4), dtype=torch.int64)
    for c in range(n_chunks(rows)):
        strips = [strip_of(c, rows, w) for w in range(WARPS)]
        q = {w: quant4(x[:, f:f + n]) for w, (f, n) in enumerate(strips) if n}
        if delta:
            last_row = {w: q[w][:, -1] for w in q}       # the shared words
            for w, (first, n) in enumerate(strips):
                if not n:
                    continue
                if first == 0:
                    prev = torch.zeros((nb, LANES // 4), dtype=torch.int64)
                elif w > 0:
                    prev = last_row[w - 1]
                else:
                    prev = quant4(x[:, first - 1:first])[:, 0]
                d = []
                for i in range(n):
                    d.append(vsub4(q[w][:, i], prev))
                    prev = q[w][:, i]
                q[w] = torch.stack(d, dim=1)
        for w, (first, n) in enumerate(strips):
            if n:
                out[:, first:first + n] = q[w]
    stream = to_bytes(out).to(torch.uint8).reshape(-1)
    return (stream if delta else stream.view(torch.int8)), scale


def decode_mirror(stream: torch.Tensor, scales: torch.Tensor, block: int,
                  delta: bool) -> torch.Tensor:
    """Inverse of ``encode_mirror``, as the decode kernel computes it."""
    nb, rows = scales.shape[0], block // LANES
    words = to_words(stream.view(torch.uint8).reshape(nb, rows, LANES))
    out = torch.zeros_like(words)
    carry = torch.zeros((nb, LANES // 4), dtype=torch.int64)
    for c in range(n_chunks(rows)):
        strips = [strip_of(c, rows, w) for w in range(WARPS)]
        q, col_total = {}, {}
        for w, (first, n) in enumerate(strips):
            run = torch.zeros_like(carry)
            rows_w = []
            for i in range(n):
                row = words[:, first + i]
                if delta:
                    run = vadd4(run, row)
                    row = run
                rows_w.append(row)
            q[w], col_total[w] = rows_w, run
        if delta:
            for w in range(WARPS):
                above = carry
                for v in range(w):
                    above = vadd4(above, col_total[v])
                q[w] = [vadd4(row, above) for row in q[w]]
            for w in range(WARPS):
                carry = vadd4(carry, col_total[w])
        for w, (first, n) in enumerate(strips):
            if n:
                out[:, first:first + n] = torch.stack(q[w], dim=1)
    signed = to_bytes(out).to(torch.uint8).view(torch.int8)
    return (signed.to(torch.float32) * scales[:, None, None]).reshape(-1)


def quant_mirror(leaf: torch.Tensor, block: int):
    """leaf (n,) f32, not padded -> (q (nb, block) int8, scales (nb,)), as
    the quant kernel computes them.  The blocks wholly inside the leaf are
    the encode's without the delta.  The last block's strips cover only its
    ceil(valid / 128) rows: the row that straddles n is read lane by lane,
    zero past n, and the rows past it are not read but written as zero
    words."""
    n = leaf.shape[0]
    whole, valid = divmod(n, block)
    q, sc = encode_mirror(leaf[:whole * block], block, False)
    if valid:
        rows = -(-valid // LANES)
        last = torch.zeros(rows * LANES)       # the masked lanes read 0
        last[:valid] = leaf[whole * block:]
        lq, lsc = encode_mirror(last, rows * LANES, False)
        q = torch.cat([q, lq, torch.zeros(block - rows * LANES, dtype=torch.int8)])
        sc = torch.cat([sc, lsc])
    return q.reshape(-1, block), sc


def dequant_mirror(q: torch.Tensor, scales: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``quant_mirror``: (n,) f32, as the dequant kernel computes
    it.  The last block's strips cover only the rows that hold values, and
    the straddling row is stored lane by lane, nothing at or past n."""
    block = q.shape[1]
    whole, valid = divmod(n, block)
    out = decode_mirror(q[:whole].reshape(-1), scales[:whole], block, False)
    if valid:
        rows = -(-valid // LANES)
        last = decode_mirror(q[whole, :rows * LANES], scales[whole:whole + 1],
                             rows * LANES, False)
        out = torch.cat([out, last[:valid]])
    return out


def quant_leaf(length: str, block: int) -> np.ndarray:
    """A leaf for the quant pair: the codec's edge blocks of normal scale,
    repeated to the length's n (so each whole block is one of them and the
    last one is cut), or the split-1-shaped leaf of scaled normals."""
    if length == "split-1 leaf":
        rng = np.random.default_rng(5)
        return (rng.normal(size=SPLIT1_LEAF) * 3).astype(np.float32)
    edge = tcodec.codec_edge_blocks(block)[:-1]          # normal scales only
    return np.resize(edge, QUANT_LENGTHS[length](block))


def _same(a: torch.Tensor, b) -> bool:
    return a.numpy().tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("rows", [1, 2, 3, 7, 8, 9, 63, 64, 65, 100, 193, 384])
def test_strips_cover_every_row_once(rows):
    """Each chunk's strips tile its rows in order, at most STRIP rows a
    warp, and the chunks tile the block."""
    seen = []
    for c in range(n_chunks(rows)):
        for w in range(WARPS):
            first, n = strip_of(c, rows, w)
            assert 0 <= n <= STRIP
            seen += range(first, first + n)
    assert seen == list(range(rows))


def test_word_ops_are_per_byte_mod_256():
    rng = np.random.default_rng(11)
    a, b = (rng.integers(0, 2**32, size=4096) for _ in range(2))
    for op, ref in ((vadd4, np.add), (vsub4, np.subtract)):
        got = op(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        for k in range(4):
            byte = lambda w: (w >> (8 * k)) & 0xFF
            assert np.array_equal(byte(got), ref(byte(a), byte(b)) % 256)


@pytest.mark.parametrize("block", BLOCKS + RAGGED)
@pytest.mark.parametrize("delta", [False, True])
def test_mirror_matches_pallas_and_plain_bitwise(block, delta):
    x = tcodec.codec_edge_blocks(block)[:-1].reshape(-1)   # normal scales only
    ms, msc = encode_mirror(torch.from_numpy(x), block, delta)
    js, jsc = jcodec.codec_encode_pallas(jnp.asarray(x), block=block,
                                         delta=delta, interpret=True)
    ps, psc = tcodec.codec_encode_plain(torch.from_numpy(x), block, delta)
    assert ms.dtype == ps.dtype == (torch.uint8 if delta else torch.int8)
    assert _same(ms, js) and _same(msc, jsc)
    assert torch.equal(ms, ps) and _same(msc, psc)
    mo = decode_mirror(ms, msc, block, delta)
    jo = jcodec.codec_decode_pallas(js, jsc, block=block, delta=delta,
                                    interpret=True)
    assert _same(mo, jo)
    assert _same(mo, tcodec.codec_decode_plain(ps, psc, block, delta))


def test_adversarial_blocks_hit_their_edges():
    """The blocks probe what they claim: exact ties, +-127 at +-absmax,
    alternating rows wrapping to deltas 254 and 2."""
    block = 1024
    x = tcodec.codec_edge_blocks(block)
    _, sc = encode_mirror(torch.from_numpy(x.reshape(-1)), block, False)
    assert float(sc[1]) == 1.0 and float(sc[2]) == 1.0
    assert np.all(x[2, 1:] - np.floor(x[2, 1:]) == 0.5)
    q, _ = encode_mirror(torch.from_numpy(x.reshape(-1)), block, False)
    q = q.reshape(8, block)
    assert set(q[3, :2].tolist()) == {127, -127}
    d, _ = encode_mirror(torch.from_numpy(x.reshape(-1)), block, True)
    rows5 = d.reshape(8, block // LANES, LANES)[5]
    assert set(rows5[1:, 0].tolist()) == {254, 2}


@pytest.mark.parametrize("block", [256, 8192, 49152])
@pytest.mark.parametrize("delta", [False, True])
def test_subnormal_scale_matches_plain_bitwise(block, delta):
    """A block whose scale is subnormal is quantised in IEEE arithmetic by
    the mirror and the plain version alike (the card does the same; the JAX
    package on the CPU flushes the scale to 0), and round-trips within half
    a step."""
    x = torch.from_numpy(tcodec.codec_edge_blocks(block)[-1:].reshape(-1))
    ms, msc = encode_mirror(x, block, delta)
    ps, psc = tcodec.codec_encode_plain(x, block, delta)
    assert 0 < float(msc[0]) < np.finfo(np.float32).tiny
    assert torch.equal(ms, ps) and _same(msc, psc)
    y = decode_mirror(ms, msc, block, delta)
    assert _same(y, tcodec.codec_decode_plain(ps, psc, block, delta))
    # half a step, plus the rounding of the subnormal product q * scale
    assert float((y - x).abs().max()) <= 0.5 * float(msc[0]) * (1 + 1e-6) + 1.5e-45


@pytest.mark.parametrize("block", QUANT_BLOCKS)
@pytest.mark.parametrize("length", [*QUANT_LENGTHS, "split-1 leaf"])
def test_ragged_mirror_matches_pallas_and_plain_bitwise(length, block):
    """The quant pair's ragged strips against quant_pallas / dequant_pallas
    (which pad the leaf in memory and slice the output) and the plain
    versions: the same int8 bytes, scale bits and decoded floats."""
    x = quant_leaf(length, block)
    t = torch.from_numpy(x)
    mq, msc = quant_mirror(t.reshape(-1), block)
    jq, jsc, jn = jquant.quant_pallas(jnp.asarray(x), block=block,
                                      interpret=True)
    pq, psc, pn = tquant.quant_plain(t, block)
    assert jn == pn == x.size and mq.shape == pq.shape == jq.shape
    assert _same(mq, jq) and _same(msc, jsc)
    assert torch.equal(mq, pq) and _same(msc, psc)
    my = dequant_mirror(mq, msc, x.size)
    jy = jquant.dequant_pallas(jq, jsc, jn, x.shape, interpret=True)
    assert _same(my, jy)
    assert _same(my, tquant.dequant_plain(pq, psc, pn, (pn,)))
