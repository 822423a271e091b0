"""Activation compression (paper §IV-C).

The counterpart of ``repro/core/compression.py``.  Two stages:

  (1) f32 -> int8 per-block absmax quantisation on the device.
  (2) zlib level 1 of the int8 bytes on the host, as in the paper.

Two encoders give interchangeable results:

  * the FUSED path (default): every leaf of a payload is packed into one
    block-aligned stream, quantised in one launch of the encode kernel
    (``kernels/csrc/codec.cu``) and copied to the host once; one zlib call
    covers the payload.  Delta mode (``int8_delta_zlib``) adds a lossless
    mod-256 delta on the quantised grid before zlib, in one of two layouts:
    ``'spatial'`` (the default: one image row along the leaf's recorded
    ``delta_axis``, applied as an integer epilogue after the encode) or
    ``'block'`` (one 128-lane row inside each quant block, done by the
    encode kernel itself).
  * the LEGACY per-tensor loop (``fused=False``, and the ``raw``/``zlib``
    modes, which never quantise): one quant launch (``kernels/csrc/
    codec.cu``, the encode's body with a ragged last block), one
    device-to-host copy and one zlib call per leaf, with the delta filter
    on the host.  It is also the decoder of every payload that is not
    fused, including ``mode=None`` payloads.

Every delta layout inverts exactly on the same quantised grid, so the
decoded tensors are bit-identical whichever encoder wrote the payload.
Given the same leaves, the blobs, scales and metas are byte-identical to
the JAX package's, and each side decodes the other's payloads: the wire
format is the blob bytes, the f32 scales and the per-leaf ``TensorMeta``.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.tree import tree_flatten

_INT8_MODES = ("int8", "int8_zlib", "int8_delta_zlib")


def spatial_delta_axis(shape: Tuple[int, ...]) -> Optional[int]:
    """The delta filter's axis, chosen once at encode time and recorded in
    ``TensorMeta.delta_axis``: the first spatial axis (skipping a leading
    batch dim smaller than 4).  None for tensors the filter skips."""
    if len(shape) < 3 or int(np.prod(shape)) == 0:
        return None
    return 1 if shape[0] < 4 else 0


def _delta_stride(shape: Tuple[int, ...], axis: int) -> int:
    return int(np.prod(shape[axis + 1:])) if len(shape) > axis + 1 else 1


@dataclass
class TensorMeta:
    shape: Tuple[int, ...]
    dtype: str                # numpy-style name: "float32", "bfloat16"
    n: int                    # valid element count (pre-padding)
    n_blocks: int
    block: int
    delta_axis: Optional[int] = None
    # index of this leaf's first quant block in the packed stream
    block_start: int = 0


@dataclass
class CompressedPayload:
    """What crosses the uplink.  A fused payload holds ONE blob and ONE
    scales array covering every leaf; ``meta[i].block_start`` locates leaf
    i's segment.  ``mode`` and ``delta_layout`` make it self-describing."""
    blobs: List[bytes]
    scales: List[np.ndarray]
    meta: List[TensorMeta]
    raw_bytes: int
    treedef: Any = None
    mode: Optional[str] = None
    fused: bool = False
    delta_layout: Optional[str] = None

    @property
    def compressed_bytes(self) -> int:
        return (sum(len(b) for b in self.blobs)
                + sum(s.nbytes for s in self.scales))

    @property
    def ratio(self) -> float:
        return self.compressed_bytes / max(self.raw_bytes, 1)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host_bytes(x: torch.Tensor) -> bytes:
    """A leaf's bytes as numpy's ``tobytes`` gives them.  numpy has no
    bfloat16, so a bf16 leaf goes through an int16 view of the same bits."""
    x = x.detach().contiguous().cpu()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy().tobytes()


def _from_bytes(buf: bytes, dtype: str, shape, device) -> torch.Tensor:
    """Inverse of ``_host_bytes`` for a leaf of ``dtype`` (a numpy-style
    name, as the metas carry it) and ``shape``."""
    np_dtype = np.int16 if dtype == "bfloat16" else np.dtype(dtype)
    t = torch.from_numpy(np.frombuffer(buf, dtype=np_dtype).copy())
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.reshape(tuple(shape)).to(device)


# ---------------------------------------------------------------------------
# the fused stream: encode, delta epilogue, decode
# ---------------------------------------------------------------------------

def _spatial_delta_apply(q_seg: torch.Tensor, shape, n: int) -> torch.Tensor:
    """int8 (nbs*block,) segment -> uint8 mod-256 delta'd segment."""
    axis = spatial_delta_axis(shape)
    if axis is None:
        return q_seg.view(torch.uint8)          # the bits, as astype wraps
    R = _delta_stride(shape, axis)
    qi = q_seg[:n].to(torch.int32)
    prev = torch.zeros_like(qi)
    if R < n:
        prev[R:] = qi[:-R]
    d = ((qi - prev) & 0xFF).to(torch.uint8)
    return torch.cat([d, q_seg[n:].view(torch.uint8)])


def _spatial_delta_invert(d_seg: torch.Tensor, shape, n: int,
                          delta_axis: Optional[int]) -> torch.Tensor:
    """uint8 segment -> int8 quantised grid (inverse of the above)."""
    if delta_axis is None:
        return d_seg.view(torch.int8)
    R = _delta_stride(shape, delta_axis)
    chains = d_seg[:n].to(torch.int64).reshape(n // R, R)
    acc = torch.cumsum(chains, dim=0) & 0xFF
    q = (acc - torch.where(acc > 127, 256, 0)).to(torch.int8).reshape(-1)
    return torch.cat([q, d_seg[n:].view(torch.int8)])


def _encode_leaves(leaves: Sequence[torch.Tensor], block: int, delta: bool,
                   layout: str, device: torch.device):
    """Pack the leaves into one block-aligned stream, quantise it in a single
    launch and, for the 'spatial' layout, apply the per-leaf delta."""
    segs, spans = [], []
    for x in leaves:
        flat = x.float().reshape(-1)
        pad = (-flat.shape[0]) % block
        if pad:
            flat = F.pad(flat, (0, pad))
        segs.append(flat)
        spans.append(flat.shape[0])
    if sum(spans) == 0:
        return (torch.zeros((0,), dtype=torch.uint8 if delta else torch.int8,
                            device=device),
                torch.zeros((0,), dtype=torch.float32, device=device))
    flat = segs[0] if len(segs) == 1 else torch.cat(segs)
    if not delta or layout == "block":
        return ops.codec_encode(flat, block=block, delta=delta)
    q, scales = ops.codec_encode(flat, block=block, delta=False)
    outs, off = [], 0
    for x, span in zip(leaves, spans):
        outs.append(_spatial_delta_apply(q[off:off + span], tuple(x.shape),
                                         x.numel()))
        off += span
    return torch.cat(outs), scales


def _to_host(stream: torch.Tensor, scales: torch.Tensor):
    """ONE device-to-host copy of the stream and the scales."""
    n = stream.shape[0]
    packed = torch.cat([stream.view(torch.uint8), scales.view(torch.uint8)])
    host = packed.cpu().numpy()
    np_dtype = np.uint8 if stream.dtype == torch.uint8 else np.int8
    return host[:n].view(np_dtype), host[n:].view(np.float32).copy()


def _decode_segments(stream: torch.Tensor, scales: torch.Tensor, segments,
                     block: int, delta: bool, layout: str) -> List[torch.Tensor]:
    """segments: per-leaf (shape, dtype, n, block_start, delta_axis)."""
    if scales.shape[0] == 0:
        flat = torch.zeros((0,), dtype=torch.float32, device=stream.device)
    elif delta and layout != "block":
        qsegs = []
        for shape, _, n, start, axis in segments:
            span = block * (-(-n // block) if n else 0)
            qsegs.append(_spatial_delta_invert(
                stream[start * block:start * block + span], shape, n, axis))
        flat = ops.codec_decode(torch.cat(qsegs), scales, block=block,
                                delta=False)
    else:
        flat = ops.codec_decode(stream, scales, block=block, delta=delta)
    return [flat[start * block:start * block + n].reshape(shape)
            .to(getattr(torch, dtype))
            for shape, dtype, n, start, _ in segments]


def _segment_metas(leaves: Sequence[torch.Tensor], block: int,
                   record_delta: bool) -> Tuple[List[TensorMeta], int, int]:
    """Per-leaf stream bookkeeping.  Returns (metas, raw_bytes, n_blocks)."""
    metas, raw, start = [], 0, 0
    for x in leaves:
        n = x.numel()
        nb = -(-n // block) if n else 0
        metas.append(TensorMeta(
            tuple(x.shape), _dtype_name(x.dtype), n, nb, block,
            delta_axis=(spatial_delta_axis(tuple(x.shape))
                        if record_delta else None),
            block_start=start))
        raw += n * x.element_size()
        start += nb
    return metas, raw, start


@dataclass
class ActivationCodec:
    """int8 + zlib codec with payload accounting.

    quant_block: elements per absmax block (one f32 scale per block).
    level: zlib level (1 = the paper's 'rapid' setting).
    mode: 'int8_zlib' (paper) | 'int8' (quant only) | 'int8_delta_zlib'
          (lossless mod-256 delta on the quantised grid before zlib)
          | 'zlib' (no quant) | 'raw' (accounting only).
    fused: encode the int8 modes with the single-launch fused path; False
          keeps the legacy per-tensor loop.  Decode follows the payload's
          own layout, so either side may flip the flag.
    delta_layout: fused delta geometry, 'spatial' (per-leaf image-row
          delta) | 'block'.
    device: where encode and decode run; "cuda" runs the kernels, "cpu" their
          plain versions.  Raises when "cuda" is asked for and absent.
    """
    quant_block: int = 8192
    level: int = 1
    mode: str = "int8_zlib"
    fused: bool = True
    delta_layout: str = "spatial"
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _use_fused(self) -> bool:
        if self.mode in _INT8_MODES and self.quant_block % 128:
            raise ValueError(f"quant_block must be a multiple of 128 (the "
                             f"kernels' row width); got {self.quant_block}")
        return self.fused and self.mode in _INT8_MODES

    def supports_fused(self) -> bool:
        """True when this codec's mode runs the single-stream fused layout
        (the precondition for ``compress_head``)."""
        return self._use_fused()

    def _leaves(self, tree):
        leaves, treedef = tree_flatten(tree)
        return [torch.as_tensor(x, device=self.device) for x in leaves], treedef

    def _payload(self, stream: np.ndarray, scales: np.ndarray, leaves,
                 treedef) -> CompressedPayload:
        delta = self.mode == "int8_delta_zlib"
        metas, raw, _ = _segment_metas(
            leaves, self.quant_block,
            record_delta=delta and self.delta_layout == "spatial")
        buf = stream.tobytes()
        blob = buf if self.mode == "int8" else zlib.compress(buf, self.level)
        return CompressedPayload([blob], [scales], metas, raw, treedef,
                                 mode=self.mode, fused=True,
                                 delta_layout=self.delta_layout if delta
                                 else None)

    def _encode(self, leaves):
        return _encode_leaves(leaves, self.quant_block,
                              self.mode == "int8_delta_zlib",
                              self.delta_layout, self.device)

    # -- compress -----------------------------------------------------------
    def compress(self, tree) -> CompressedPayload:
        if not self._use_fused():
            return self._compress_legacy(tree)
        leaves, treedef = self._leaves(tree)
        stream, scales = _to_host(*self._encode(leaves))
        return self._payload(stream, scales, leaves, treedef)

    def _compress_legacy(self, tree) -> CompressedPayload:
        """One quant launch, one device-to-host copy and one zlib call per
        leaf; the ``int8_delta_zlib`` delta runs on the host."""
        leaves, treedef = self._leaves(tree)
        blobs, scales, metas = [], [], []
        raw = 0
        for x in leaves:
            raw += x.numel() * x.element_size()
            if self.mode in ("raw", "zlib"):
                buf = _host_bytes(x)
                blobs.append(buf if self.mode == "raw"
                             else zlib.compress(buf, self.level))
                scales.append(np.zeros((0,), np.float32))
                metas.append(TensorMeta(tuple(x.shape), _dtype_name(x.dtype),
                                        x.numel(), 0, 0))
                continue
            q, s, n = ops.quantize(x, block=self.quant_block)
            q_flat, s_np = _to_host(q.reshape(-1), s)
            q_np = q_flat.reshape(q.shape)
            delta_axis = (spatial_delta_axis(tuple(x.shape))
                          if self.mode == "int8_delta_zlib" else None)
            if self.mode == "int8":
                payload = q_np.tobytes()
            elif delta_axis is not None:
                img = q_np.reshape(-1)[:n].reshape(tuple(x.shape))
                # exact mod-256 delta (d[0] = x[0], so the inverse is a
                # cumsum mod 256)
                d16 = np.diff(img.astype(np.int16), axis=delta_axis,
                              prepend=np.zeros_like(
                                  np.take(img, [0], axis=delta_axis), np.int16))
                d = (d16 % 256).astype(np.uint8)
                tail = q_np.reshape(-1)[n:]           # block padding
                payload = zlib.compress(d.tobytes() + tail.tobytes(), self.level)
            else:
                payload = zlib.compress(q_np.tobytes(), self.level)
            blobs.append(payload)
            scales.append(s_np)
            metas.append(TensorMeta(tuple(x.shape), _dtype_name(x.dtype), n,
                                    int(q.shape[0]), int(q.shape[1]),
                                    delta_axis=delta_axis))
        return CompressedPayload(blobs, scales, metas, raw, treedef,
                                 mode=self.mode)

    def compress_head(self, producer, params, inputs):
        """Run ``producer(params, inputs)`` (a stable callable such as
        ``SwinSplitPlan.head_jitted``) and encode its output on the device,
        with one device-to-host copy (one per leaf where the codec does not
        fuse).  Returns (CompressedPayload, tree); the payload is
        byte-identical to ``compress(producer(...))``."""
        tree = producer(params, inputs)
        if not self._use_fused():
            return self.compress(tree), tree
        leaves, treedef = self._leaves(tree)
        stream, scales = _to_host(*self._encode(leaves))
        return self._payload(stream, scales, leaves, treedef), tree

    def compress_group(self, trees: Sequence[Any]) -> List[CompressedPayload]:
        """Encode many payloads in ONE launch.  Each payload's byte range is
        zlib'd separately, so the result is byte-identical to per-payload
        ``compress``.  The legacy path encodes payload by payload."""
        if not trees or len(trees) == 1 or not self._use_fused():
            return [self.compress(t) for t in trees]
        per_tree, flat = [], []
        for t in trees:
            leaves, treedef = self._leaves(t)
            per_tree.append((leaves, treedef))
            flat.extend(leaves)
        stream, scales = _to_host(*self._encode(flat))
        out, start, block = [], 0, self.quant_block
        for leaves, treedef in per_tree:
            nb = sum(-(-x.numel() // block) for x in leaves)
            out.append(self._payload(
                stream[start * block:(start + nb) * block],
                scales[start:start + nb].copy(), leaves, treedef))
            start += nb
        return out

    # -- decompress ----------------------------------------------------------
    @staticmethod
    def _fused_stream(p: CompressedPayload) -> np.ndarray:
        delta = p.mode == "int8_delta_zlib"
        raw = p.blobs[0] if p.mode == "int8" else zlib.decompress(p.blobs[0])
        return np.frombuffer(raw, dtype=np.uint8 if delta else np.int8)

    def _decode(self, stream: np.ndarray, scales: np.ndarray, segments,
                block: int, mode: str, layout: Optional[str]):
        return _decode_segments(
            torch.from_numpy(stream.copy()).to(self.device),
            torch.from_numpy(np.asarray(scales, np.float32).copy()).to(self.device),
            segments, block, mode == "int8_delta_zlib", layout or "block")

    def decompress(self, p: CompressedPayload):
        """Decode a payload (the port's or the JAX package's: the tree
        definition only needs an ``unflatten`` method)."""
        if not p.fused:
            return self._decompress_legacy(p)
        block = p.meta[0].block if p.meta else self.quant_block
        segments = tuple((tuple(m.shape), m.dtype, m.n, m.block_start,
                          m.delta_axis) for m in p.meta)
        leaves = self._decode(self._fused_stream(p), p.scales[0], segments,
                              block, p.mode, p.delta_layout)
        return p.treedef.unflatten(leaves)

    def decompress_group(self, ps: Sequence[CompressedPayload]) -> List[Any]:
        """Decode many fused payloads with one upload and one launch (the
        edge side of ``compress_group``); the leaves stay on the device,
        ready for ``SwinSplitPlan.tail_batched``.  Payloads that are not
        all fused are decoded one by one."""
        if len(ps) <= 1 or not all(p.fused for p in ps):
            return [self.decompress(p) for p in ps]
        kinds = {(p.mode, p.delta_layout) for p in ps} \
            | {("block", m.block) for p in ps for m in p.meta}
        if len(kinds) > 2:      # one (mode, layout) + one ("block", size)
            raise ValueError(f"group mixes codec settings: {sorted(kinds)}; "
                             "decompress_group needs one mode/layout/block")
        block = next((m.block for p in ps for m in p.meta), self.quant_block)
        segments, start = [], 0
        for p in ps:
            for m in p.meta:
                segments.append((tuple(m.shape), m.dtype, m.n,
                                 start + m.block_start, m.delta_axis))
            start += sum(m.n_blocks for m in p.meta)
        stream = np.concatenate([self._fused_stream(p) for p in ps])
        scales = np.concatenate([p.scales[0] for p in ps])
        leaves = self._decode(stream, scales, segments, block, ps[0].mode,
                              ps[0].delta_layout)
        out, off = [], 0
        for p in ps:
            out.append(p.treedef.unflatten(leaves[off:off + len(p.meta)]))
            off += len(p.meta)
        return out

    def _decompress_legacy(self, p: CompressedPayload):
        """The per-leaf decoder.  The payload's own mode wins; a payload
        with ``mode=None`` takes this codec's."""
        mode = p.mode if p.mode is not None else self.mode
        leaves = []
        for blob, s, m in zip(p.blobs, p.scales, p.meta):
            if mode in ("raw", "zlib"):
                buf = blob if mode == "raw" else zlib.decompress(blob)
                leaves.append(_from_bytes(buf, m.dtype, m.shape, self.device))
                continue
            raw = blob if mode == "int8" else zlib.decompress(blob)
            if mode == "int8_delta_zlib" and len(m.shape) >= 3:
                n_valid = int(np.prod(m.shape))
                d = np.frombuffer(raw[:n_valid], dtype=np.uint8).reshape(m.shape)
                # payloads from before delta_axis was recorded: the old rule
                axis = (m.delta_axis if m.delta_axis is not None
                        else (1 if m.shape[0] < 4 else 0))
                img = (np.cumsum(d.astype(np.int64), axis=axis) % 256
                       ).astype(np.uint8).view(np.int8)
                tail = np.frombuffer(raw[n_valid:], dtype=np.int8)
                raw = img.tobytes() + tail.tobytes()
            q = np.frombuffer(raw, dtype=np.int8).reshape(m.n_blocks, m.block)
            leaves.append(ops.dequantize(
                torch.from_numpy(q.copy()).to(self.device),
                torch.from_numpy(np.asarray(s, np.float32).copy()).to(self.device),
                m.n, tuple(m.shape), getattr(torch, m.dtype)))
        return p.treedef.unflatten(leaves)

    # -- accounting only ------------------------------------------------------
    # Default entropy-coding ratios per mode when no measured feedback is
    # available yet (the JAX package's values).
    DEFAULT_RATIOS = {"int8_zlib": 0.55, "int8_delta_zlib": 0.47, "zlib": 0.90}

    def estimate_bytes(self, shapes_dtypes, measured_ratio: Optional[float] = None):
        """Predict compressed payload size from tensor specs.

        measured_ratio: zlib ratio observed on recent frames.  It applies to
        the int8 stream for the int8* modes and to the raw float bytes for
        'zlib'; defaults are mode-aware (DEFAULT_RATIOS)."""
        raw = sum(int(np.prod(s)) * np.dtype(d).itemsize for s, d in shapes_dtypes)
        if self.mode == "raw":
            return raw
        if self.mode == "zlib":
            r = (measured_ratio if measured_ratio is not None
                 else self.DEFAULT_RATIOS["zlib"])
            return int(raw * r)
        n_elems = sum(int(np.prod(s)) for s, _ in shapes_dtypes)
        int8 = n_elems + 4 * (n_elems // self.quant_block + len(shapes_dtypes))
        if self.mode == "int8":
            return int8
        r = (measured_ratio if measured_ratio is not None
             else self.DEFAULT_RATIOS[self.mode])
        return int(int8 * r)
