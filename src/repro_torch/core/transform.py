"""Model transformation: train-state → serve-state (paper §4.1.4b) —
counterpart of the reference's ``core/transform.py``.

The master's rows are (w, optimizer slots); the slave needs only inference
weights, possibly re-encoded. A ``Transform`` pairs an ``encode`` (runs on
the pusher, master side) with a ``decode`` (runs on the scatter, slave
side). Encodings are *plain data* (NumPy arrays) so they survive the
queue; the codec is named in the record's metadata and resolved from this
registry on the consuming side.

Codecs:
  * identity    — serve weights as-is (fp32)
  * cast16      — fp16 cast (half bandwidth)
  * int8        — row-wise absmax int8 quantization (the
                  ``quantize_rows``/``dequantize_rows`` kernels)
  * with an FTRL optimizer attached, encode reads slots (z, n) and ships
    the *derived* w

Backends — mirroring the PS row engine's ``numpy|torch`` switch:
  * ``numpy``  — host codecs;
  * ``torch``  — the int8 path runs the ``delta_codec`` kernels on
    ``device`` (the card by default; their plain versions on
    ``device="cpu"``). Codecs without a kernel (identity, cast16) keep
    the NumPy engine end to end (``kernel_backed`` gates the routing, as
    in the reference).

Serve values (FTRL z, n → w) are always derived on the host with
``serve_weights_np``, as in the reference, so decoded weights stay
bit-identical across backends. ``encode`` is backend-routed per
*instance* (the pusher owns a configured ``Transform``); ``decode`` per
*call* (the scatter passes its shard's backend and device), so producer
and consumer backends are independent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.ps import _upload, resolve_device
from repro_torch.kernels import ops
from repro_torch.optim import FTRL, Optimizer

CODEC_BACKENDS = ("numpy", "torch")

# Encode tile height on the numpy backend: 8k-row tiles (~2 MB at dim 64)
# keep the serve + codec passes in L2.
_ENCODE_BLOCK = 8192


def _check_backend(backend: str) -> None:
    if backend not in CODEC_BACKENDS:
        raise ValueError(f"codec backend must be one of {CODEC_BACKENDS}, "
                         f"got {backend!r}")


class Transform:
    name: str = "identity"
    kernel_backed: bool = False     # has a codec kernel

    def __init__(self, optimizer: Optional[Optimizer] = None,
                 backend: str = "torch", device="cuda"):
        _check_backend(backend)
        self.optimizer = optimizer
        self.backend = backend
        self.device = resolve_device(device) if backend == "torch" else None

    @property
    def _device_path(self) -> bool:
        """True when encode runs on the device: backend torch AND this
        codec has a kernel."""
        return self.backend == "torch" and self.kernel_backed

    @property
    def requires_w(self) -> bool:
        """Whether encode reads the stored weights. With an optimizer
        attached, serve weights derive from ``serve_slot_names`` alone,
        so the pusher skips gathering w."""
        return self.optimizer is None

    @property
    def required_slots(self) -> tuple:
        """Slot columns encode reads — () for plain weight codecs."""
        return self.optimizer.serve_slot_names if self.optimizer else ()

    def _iter_serve(self, w: np.ndarray, slots: dict):
        """Yield (lo, hi, serve_values(block)) over cache-sized row tiles.
        Single block on the device path, for small inputs, and when slot
        arrays are not row-aligned with ``w`` (the dense encode path)."""
        n = w.shape[0]
        if (self._device_path or n <= _ENCODE_BLOCK
                or any(np.asarray(v).shape[:1] != (n,)
                       for v in slots.values())):
            yield 0, n, self.serve_values(w, slots)
            return
        for lo in range(0, n, _ENCODE_BLOCK):
            hi = min(lo + _ENCODE_BLOCK, n)
            yield lo, hi, self.serve_values(
                w[lo:hi], {k: v[lo:hi] for k, v in slots.items()})

    def _assemble(self, w: np.ndarray, slots: dict, finalize) -> dict:
        """Run ``finalize`` (serve-values block → payload arrays) over the
        serve tiles and assemble full payload arrays."""
        n, out = w.shape[0], None
        for lo, hi, v in self._iter_serve(w, slots):
            part = finalize(v)
            if lo == 0 and hi == n:
                return part
            if out is None:
                out = {k: np.empty((n,) + a.shape[1:], a.dtype)
                       for k, a in part.items()}
            for k, a in part.items():
                out[k][lo:hi] = a
        return out

    def serve_values(self, w: np.ndarray, slots: dict) -> np.ndarray:
        """Inference weights from master state, always host-side
        (``serve_weights_np``): the backend switch covers the codec
        kernel only, so decoded weights stay bit-identical across
        backends."""
        if self.optimizer is not None:
            return self.optimizer.serve_weights_np(w, slots)
        return w

    def encode(self, w: np.ndarray, slots: dict) -> dict:
        if self.optimizer is None:               # pure pass-through
            return {"values": w.astype(np.float32, copy=False)}
        return self._assemble(
            w, slots,
            lambda v: {"values": v.astype(np.float32, copy=False)})

    @staticmethod
    def decode(payload: dict, backend: str = "torch",
               device="cuda") -> np.ndarray:
        return payload["values"]

    def payload_bytes(self, payload: dict) -> int:
        return sum(np.asarray(v).nbytes for v in payload.values())


class Cast16Transform(Transform):
    name = "cast16"

    def encode(self, w, slots):
        return self._assemble(
            w, slots, lambda v: {"values16": v.astype(np.float16)})

    @staticmethod
    def decode(payload, backend: str = "torch", device="cuda"):
        return payload["values16"].astype(np.float32)


class Int8Transform(Transform):
    """Row-wise absmax int8: 4x bandwidth reduction on the push stage.
    ``backend="torch"`` runs the ``delta_codec`` kernels on ``device``;
    ``numpy`` is their host mirror (bit-compatible: same arithmetic)."""

    name = "int8"
    kernel_backed = True

    @staticmethod
    def _quantize_np(v: np.ndarray) -> dict:
        v = v.astype(np.float32, copy=False)
        # reciprocal multiply, matching the kernel (see delta_codec.cu)
        s = np.maximum(np.abs(v).max(axis=-1, keepdims=True)
                       * np.float32(1.0 / 127.0), 1e-12)
        q = np.clip(np.rint(v / s), -127, 127).astype(np.int8)
        return {"q": q, "scale": s.astype(np.float32, copy=False)}

    def encode(self, w, slots):
        # guard on row count, not w.size: with an optimizer attached the
        # pusher passes a (n, 0) w placeholder (columns come from slots)
        if self._device_path and len(w):
            v = self.serve_values(w, slots).astype(np.float32, copy=False)
            q, scale = ops.quantize_rows(_upload(v, self.device))
            return {"q": q.cpu().numpy(), "scale": scale.cpu().numpy()}
        return self._assemble(w, slots, self._quantize_np)

    @staticmethod
    def decode(payload, backend: str = "torch", device="cuda"):
        _check_backend(backend)
        q = payload["q"]
        if backend == "torch" and q.size:
            dev = resolve_device(device)
            return ops.dequantize_rows(
                _upload(q, dev),
                _upload(payload["scale"], dev)).cpu().numpy()
        return q.astype(np.float32) * payload["scale"]


_TRANSFORMS: dict[str, type[Transform]] = {
    t.name: t for t in (Transform, Cast16Transform, Int8Transform)
}


def make_transform(codec: str, optimizer: Optional[Optimizer] = None,
                   backend: str = "torch", device="cuda") -> Transform:
    """codec in {identity, cast16, int8}. If the optimizer has serve-slot
    semantics (FTRL), ``serve_values`` derives w from them. ``backend``
    and ``device`` select the codec engine (see module docstring)."""
    cls = _TRANSFORMS[codec]
    needs_opt = optimizer is not None and (
        isinstance(optimizer, FTRL) or optimizer.serve_slot_names)
    return cls(optimizer if needs_opt else None, backend=backend,
               device=device)


def decode_record(record, backend: str = "torch",
                  device="cuda") -> np.ndarray:
    """Consumer-side decode: codec resolved from ``record.meta["codec"]``
    (identity for records without one), backend and device chosen by the
    *consumer*."""
    codec = record.meta.get("codec", "identity")
    return _TRANSFORMS[codec].decode(record.payload, backend=backend,
                                     device=device)
