"""Multi-session lanes over one or several devices (the port's
``selkies_tpu/parallel/``).

A **lane** batches N sessions of one geometry and profile into one device
step per shard per tick: the JPEG lane (:class:`MeshStripeEncoder`) and
the striped H.264 lane (:class:`~.mesh_h264.MeshH264Encoder`) split the
sessions over the mesh's "session" axis and each frame's stripe bands over
its "stripe" axis (split-frame encoding), and within a shard fold the
sessions into the frame's rows, so one launch of each kernel per shard
carries the shard's sessions, and each session's bytes equal its solo
encoder's. The scheduler (:mod:`.coordinator`) owns the lanes: admission,
growth and retirement, slot health, quarantine and live migration, and
split-frame lanes for large geometries.

The names match the JAX package's. :class:`Mesh` is a ("session",
"stripe") grid of ``torch.device``\\ s.
"""

from .mesh import (BatchedSessionEncoder, Mesh, MeshStripeEncoder,
                   make_batched_entropy_step, make_batched_step, make_mesh,
                   parse_mesh_spec)

__all__ = [
    "Mesh",
    "make_mesh",
    "parse_mesh_spec",
    "make_batched_step",
    "make_batched_entropy_step",
    "BatchedSessionEncoder",
    "MeshStripeEncoder",
]
