"""The port stands alone: no jax, no selkies_tpu, and no quiet CPU fallback."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "selkies_tpu_torch"


def _port_files():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 20
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "selkies_tpu" or name.startswith("selkies_tpu."))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and _forbidden(node.args[0].value):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_with_jax_and_jax_package_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['selkies_tpu'] = None\n"
        "import selkies_tpu_torch\n"
        "import selkies_tpu_torch.__main__\n"
        "import selkies_tpu_torch.server.main\n"
        "import selkies_tpu_torch.server.data_server\n"
        "import selkies_tpu_torch.robustness\n"
        "import selkies_tpu_torch.encoder.pipeline\n"
        "import selkies_tpu_torch.encoder.state\n"
        "import selkies_tpu_torch.ops.dct_quant\n"
        "import selkies_tpu_torch.ops.me_mc\n"
        "import selkies_tpu_torch.native\n"
        "import selkies_tpu_torch.encoder.h264\n"
        "import selkies_tpu_torch.encoder.h264_device\n"
        "import selkies_tpu_torch.encoder.device_cavlc\n"
        "import selkies_tpu_torch.parallel\n"
        "import selkies_tpu_torch.parallel.coordinator\n"
        "import selkies_tpu_torch.robustness.slot_health\n"
        "import selkies_tpu_torch.robustness.ratelimit\n"
        "import selkies_tpu_torch.display\n"
        "import selkies_tpu_torch.server.app\n"
        "import selkies_tpu_torch.observability\n"
        "import selkies_tpu_torch.observability.tracing\n"
        "import selkies_tpu_torch.capture.x11\n"
        "import selkies_tpu_torch.input\n"
        "import selkies_tpu_torch.input.cursor\n"
        "import selkies_tpu_torch.audio\n"
        "import selkies_tpu_torch.rtc\n"
        "from selkies_tpu_torch.server import bundled_web_root\n"
        "assert bundled_web_root() is not None\n"
        "from selkies_tpu_torch.audio import opus_available\n"
        "opus_available()\n"
        "from selkies_tpu_torch.parallel import MeshStripeEncoder, parse_mesh_spec\n"
        "from selkies_tpu_torch.parallel.mesh_h264 import MeshH264Encoder\n"
        "from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder\n"
        "from selkies_tpu_torch.encoder.pipeline import ThreadedEncoderAdapter\n"
        "import numpy as np\n"
        "enc = JpegStripeEncoder(32, 16, stripe_height=16, device='cpu')\n"
        "assert len(enc.encode_frame(np.zeros((16, 32, 3), np.uint8))) == 1\n"
        "ad = ThreadedEncoderAdapter(JpegStripeEncoder(\n"
        "    32, 16, stripe_height=16, entropy='host', device='cpu'))\n"
        "ad.submit(np.zeros((16, 32, 3), np.uint8))\n"
        "assert len(ad.flush()[0][1]) == 1\n"
        "ad.close()\n"
        "assert ad.join(10.0)\n"
        "mesh = parse_mesh_spec('session:1', ['cpu'])\n"
        "f = np.zeros((2, 16, 32, 3), np.uint8)\n"
        "out, _ = MeshStripeEncoder(mesh, 2, 32, 16, stripe_h=16).encode_frames(f)\n"
        "assert [len(o) for o in out] == [1, 1]\n"
        "out, _ = MeshH264Encoder(mesh, 2, 32, 16, stripe_h=16).encode_frames(f)\n"
        "assert [len(o) for o in out] == [1, 1]\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'selkies_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('isolated')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_h264_path_opens_and_loads_nothing_of_the_jax_package():
    """An audit hook records every file opened and every library loaded
    while the port encodes an IDR and a P frame of x264enc-striped, a
    full-frame P frame with host entropy and a frame of the JPEG host rung
    (the two host coders are built and loaded then): none lies under
    selkies_tpu/, whose prebuilt _libselkies_cavlc.so and
    _libselkies_entropy.so the port must not use."""
    code = (
        "import os, sys\n"
        "seen = []\n"
        "def hook(event, args):\n"
        "    if event in ('open', 'ctypes.dlopen') and args and \\\n"
        "            isinstance(args[0], (str, bytes)):\n"
        "        seen.append(os.fsdecode(args[0]))\n"
        "sys.addaudithook(hook)\n"
        "import numpy as np\n"
        "from selkies_tpu_torch.encoder.h264 import H264StripeEncoder\n"
        "enc = H264StripeEncoder(64, 32, stripe_height=32, device='cpu')\n"
        "f = np.random.default_rng(0).integers(0, 256, (32, 64, 3), np.uint8)\n"
        "assert enc.encode_frame(f)[0].is_key\n"
        "assert not enc.encode_frame(np.roll(f, 2, 0))[0].is_key\n"
        "enc = H264StripeEncoder(64, 32, fullframe=True, entropy='host',\n"
        "                        device='cpu')\n"
        "enc.encode_frame(f)\n"
        "assert len(enc.encode_frame(np.roll(f, 2, 1))) == 1\n"
        "from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder\n"
        "jenc = JpegStripeEncoder(64, 32, stripe_height=16, entropy='host',\n"
        "                         device='cpu')\n"
        "assert len(jenc.encode_frame(f)) == 2\n"
        "jax_pkg = os.path.realpath('selkies_tpu') + os.sep\n"
        "bad = [p for p in seen if os.path.realpath(p).startswith(jax_pkg)]\n"
        "assert not bad, bad\n"
        "assert any('libcavlc_host_' in p for p in seen), seen\n"
        "assert any('libentropy_host_' in p for p in seen), seen\n"
        "print('isolated', len(seen))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_encoder_without_card_or_device_raises(monkeypatch):
    from selkies_tpu_torch import resolve_device
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder

    from selkies_tpu_torch.encoder.h264 import H264StripeEncoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        JpegStripeEncoder(64, 64)
    with pytest.raises(RuntimeError):
        H264StripeEncoder(64, 64)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_server_entry_point_without_card_raises(monkeypatch):
    import asyncio

    from selkies_tpu_torch.server import main as tmain
    from selkies_tpu_torch.settings import Settings

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        asyncio.run(tmain._amain(Settings(argv=[], env={"SELKIES_PORT": "0"})))


def test_kernel_build_is_lazy_and_sources_ship():
    """Importing the port never builds or loads a kernel (no nvcc here);
    the CUDA sources sit in the package for the build at first use."""
    code = ("import selkies_tpu_torch.server.main\n"
            "import selkies_tpu_torch.ops.dct_quant\n"
            "import selkies_tpu_torch.ops.me_mc\n"
            "import selkies_tpu_torch.encoder.h264\n"
            "import selkies_tpu_torch.parallel.coordinator\n"
            "import selkies_tpu_torch.parallel.mesh_h264\n"
            "from selkies_tpu_torch import _build\n"
            "assert _build._loaded == {} and _build.ptxas_report == {}\n"
            "print(_build.kernel_dir())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("build/torch_kernels")
    assert (PORT / "csrc" / "dct_quant.cu").is_file()
    assert (PORT / "csrc" / "me_mc.cu").is_file()
    assert (PORT / "native" / "cavlc.cpp").is_file()
    assert (PORT / "native" / "entropy.cpp").is_file()
