"""selkies_tpu_torch — the PyTorch/CUDA port of ``selkies_tpu``.

A second package beside the JAX one, laid out like it (``ops/``,
``encoder/``, ``server/``, ``protocol/``, ``capture/``) so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax``, and no
module of ``selkies_tpu``: what it needs from there it keeps as its own
copy. The JAX package stays the reference the port is held against
(tests/test_torch_*.py).

This slice serves the default JPEG-stripe profile: color, 4:2:0, the
hand-written Hopper DCT+quant+zigzag kernel (``csrc/dct_quant.cu``), the
Huffman packer as tensor code, the pipelined encoder, and a reduced
websocket data server.
"""

from ._device import resolve_device  # noqa: F401

__version__ = "0.1.0"
