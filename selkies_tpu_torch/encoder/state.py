"""Carry a JPEG encoder's stream state across packages as numpy arrays.

The encoder has no weights. What one encoder hands another is its tables
and its stream state: the quant tables, the damage reference frame, and the
per-stripe static/paint-over history. With these, an encoder of this port
resumes mid-stream from a JAX ``JpegStripeEncoder``'s state (or from
another port encoder's) and emits the same bytes from there on.

Arrays (the JAX encoder's attribute in brackets):
  qy, qc        [nq, 8, 8] f32 quant tables, index 0 normal, 1 paint-over
                (``_qy``, ``_qc``)
  prev          [pad_h, pad_w, 3] uint8 damage reference (``_prev``)
  static_frames [S] int64 consecutive static frames per stripe
  painted       [S] bool paint-over already emitted per stripe
  first_frame   scalar bool: the next frame emits every stripe
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

STATE_KEYS = ("qy", "qc", "prev", "static_frames", "painted", "first_frame")


def export_encoder_state(enc) -> Dict[str, np.ndarray]:
    """This port's ``JpegStripeEncoder`` state as numpy arrays."""
    with enc.stream_context():
        prev = enc._prev.cpu().numpy().copy()
    return {
        "qy": np.stack(enc._qy_np).astype(np.float32),
        "qc": np.stack(enc._qc_np).astype(np.float32),
        "prev": prev,
        "static_frames": enc._static_frames.copy(),
        "painted": enc._painted.copy(),
        "first_frame": np.asarray(enc._first_frame),
    }


def load_encoder_state(enc, arrays: Dict[str, np.ndarray]) -> None:
    """Resume ``enc`` (this port's ``JpegStripeEncoder``) from ``arrays``."""
    missing = [k for k in STATE_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"encoder state lacks {missing}")
    qy = np.asarray(arrays["qy"], np.float32)
    qc = np.asarray(arrays["qc"], np.float32)
    if qy.shape[1:] != (8, 8) or qc.shape[1:] != (8, 8) or len(qy) < 2:
        raise ValueError("qy/qc must be [nq>=2, 8, 8] quant tables")
    prev = np.asarray(arrays["prev"], np.uint8)
    if prev.shape != (enc.pad_h, enc.pad_w, 3):
        raise ValueError(f"prev must be {(enc.pad_h, enc.pad_w, 3)}, "
                         f"got {prev.shape}")
    static = np.asarray(arrays["static_frames"], np.int64)
    painted = np.asarray(arrays["painted"], bool)
    if static.shape != (enc.n_stripes,) or painted.shape != (enc.n_stripes,):
        raise ValueError(f"stripe history must have {enc.n_stripes} entries")
    enc._set_tables(qy, qc)
    with enc.stream_context():
        enc._prev.copy_(torch.from_numpy(np.array(prev)))
    # the stream is the card's one encoder stream: this also waits for
    # other encoders' queued work (correct, only slower)
    enc.synchronize()
    enc._static_frames[:] = static
    enc._painted[:] = painted
    enc._first_frame = bool(np.asarray(arrays["first_frame"]))
