#!/usr/bin/env python3
"""Drive the PyTorch port (selkies_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py            # from the root of a checkout, one card

It builds the port's CUDA kernels from the checkout's sources, holds each
kernel against its plain PyTorch version at the 1080p main-path shapes,
drives the served JPEG-stripe path at 1920x1080 (the pipelined encoder
behind the async driver, then the data server's ws_handler with an
in-process client), shows through the launch counters that the path ran
the kernels, and checks the output by the repo's own means: after each
timed encoder run, every stripe scan it produced must equal the host
coder (entropy_py) on that frame's own coefficients fetched from the
card; a 1080p run whose noise stripes overflow the device packer is
host-coded and checked the same way; and a small frame sequence encoded on the card equals the same
sequence encoded on the CPU, whose bytes the CPU tests hold equal to the
JAX package's.

It prints one JSON object per line (setup, kernels, encoder, server), the
card's name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result. It imports neither jax nor selkies_tpu, and
needs neither websockets nor PIL.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and f32
#: non-tensor-core FLOP/s, for the bound of a kernel's work
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

W, H = 1920, 1080
STRIPE = 64
#: frames in each timed encoder run
N_FRAMES = 120
#: where the port runs (a CPU rehearsal of the phases may set "cpu")
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_time_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events); with
    ``flush`` the L2 cache is overwritten before each timed run."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def device_ms(fn, reps: int):
    """Device time of ``fn()`` per run: torch.profiler's device intervals
    summed over ``reps`` back-to-back runs (warm L2, as on the main path,
    where the planes were written by the color pass just before). Unlike
    CUDA events around the calls it excludes the gaps in which the device
    waits for the host to enqueue the next launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps


# ---------------------------------------------------------------------------
# phases


def phase_setup():
    import torch

    from selkies_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi = smi[torch.cuda.current_device()] if smi else "unknown"
    print(smi, flush=True)
    stems = sorted(p[:-3] for p in os.listdir(_build.CSRC) if p.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(stems)) as pool:     # one nvcc per source
        list(pool.map(_build.load_library, stems))
    build_s = time.perf_counter() - t0
    emit({"phase": "setup", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernels_built": stems,
          "build_s": round(build_s, 3),
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in _build.ptxas_report.items()}})
    return smi


def _main_path_planes(frame_np, enc):
    """The Y, Cb, Cr planes and band table indices the main path hands the
    kernel for one frame (the encoder's own color/4:2:0 on the card)."""
    import torch

    from selkies_tpu_torch.ops.color import rgb_to_ycbcr, subsample_420

    f = torch.from_numpy(enc._pad(frame_np)).to(enc.device)
    y, cb, cr = rgb_to_ycbcr(f)
    cb, cr = subsample_420(cb).contiguous(), subsample_420(cr).contiguous()
    qsel = torch.arange(enc.n_stripes, device=enc.device, dtype=torch.int32) % 2
    row_y = qsel[torch.arange(y.shape[0] // 8, device=enc.device) // (STRIPE // 8)]
    row_c = qsel[torch.arange(cb.shape[0] // 8, device=enc.device) // (STRIPE // 16)]
    return [(y, enc._recip_y, row_y.contiguous()),
            (cb, enc._recip_c, row_c.contiguous()),
            (cr, enc._recip_c, row_c.contiguous())]


def phase_kernel_check():
    """dct8_quant_zigzag against its plain version at the 1080p shapes,
    q40/q90 bands alternating by stripe; then kernel, plain and library
    (one torch.einsum DCT) times, and the bound of the work."""
    import torch

    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder
    from selkies_tpu_torch.ops import dct as tdct
    from selkies_tpu_torch.ops.dct_quant import (dct8_quant_zigzag,
                                                 dct8_quant_zigzag_plain)

    enc = JpegStripeEncoder(W, H, stripe_height=STRIPE, device=DEVICE)
    frames = {
        "scroll": SyntheticSource(W, H, pattern="scroll", seed=0).next_frame(),
        "noise": SyntheticSource(W, H, pattern="noise", seed=1).next_frame(),
    }
    n_coef = n_diff = 0
    max_err = 0
    for frame in frames.values():
        for plane, recip, row in _main_path_planes(frame, enc):
            got = dct8_quant_zigzag(plane, recip, row)
            want = dct8_quant_zigzag_plain(plane, recip, row)
            torch.cuda.synchronize()
            d = (got.int() - want.int()).abs()
            max_err = max(max_err, int(d.max().item()))
            n_diff += int((d > 0).sum().item())
            n_coef += d.numel()
    equal_share = 1.0 - n_diff / n_coef
    check(max_err <= 1, f"kernel vs plain max |diff| {max_err} > 1")
    check(equal_share >= 0.999, f"kernel vs plain equal share {equal_share}")

    planes = _main_path_planes(frames["noise"], enc)
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def kernel():
        for p, r, i in planes:
            dct8_quant_zigzag(p, r, i)

    def plain():
        for p, r, i in planes:
            dct8_quant_zigzag_plain(p, r, i)

    blocks = [tdct.blockify(p) - 128.0 for p, _, _ in planes]

    def library():
        for b in blocks:
            tdct.block_dct2_einsum(b)

    flush = flush_buf.zero_
    kernel_ms = device_ms(kernel, 100)
    plain_ms = device_ms(plain, 10)
    library_ms = device_ms(library, 50)
    check(None not in (kernel_ms, plain_ms, library_ms),
          "profiler recorded no device time")
    # CUDA events around the three calls, L2 overwritten before each: the
    # host-visible cost, launch gaps included
    events_cold_ms = cuda_time_ms(kernel, 50, flush)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 left on for the library DCT")

    in_bytes = sum(p.numel() * 4 + r.numel() * 4 + i.numel() * 4
                   for p, r, i in planes)
    out_bytes = sum(p.numel() * 2 for p, _, _ in planes)
    n_blocks = sum(p.numel() // 64 for p, _, _ in planes)
    # per block: 2 passes x 64 outputs x 8 multiply-adds, level shift,
    # quantizing multiply
    flops = n_blocks * (2 * 64 * 8 * 2 + 64 + 64)
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    return {
        "name": "dct8_quant_zigzag",
        "route": "cuda",
        "source": "selkies_tpu_torch/csrc/dct_quant.cu",
        "replaces": "selkies_tpu/ops/pallas_dct.py:75",
        "launches": None,                   # filled from the main-path run
        "max_abs_err": max_err,
        "n_diff": n_diff,
        "n_coeffs": n_coef,
        "equal_share": equal_share,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "ms_timing": "torch.profiler device time, warm L2, 100 reps",
        "events_ms_cold_l2": events_cold_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "library_call": "torch.einsum('ij,...jk,lk->...il') DCT only, f32",
        "unit": "one 1080p frame: Y 1088x1920 + Cb, Cr 544x960, 3 launches",
        "bytes": in_bytes + out_bytes,
        "flops": flops,
    }


def _recording(base):
    """Wrap base._scans_from_packed to keep, for every frame it codes, the
    scans it returned, the frame's emit and overflow flags and its
    coefficient tensors on the card; _check_recorded checks them."""
    orig = base._scans_from_packed
    kept = []

    def wrapped(words_np, base_np, nbytes_np, ovf_np, emit, yq, cbq, crq):
        scans = orig(words_np, base_np, nbytes_np, ovf_np, emit, yq, cbq, crq)
        kept.append((scans, emit.copy(), ovf_np.copy(), yq, cbq, crq))
        return scans

    base._scans_from_packed = wrapped
    return kept


def _check_recorded(base, kept) -> dict:
    """Every kept stripe scan must equal entropy_py on that frame's own
    coefficients, fetched from the card."""
    from selkies_tpu_torch.encoder import entropy_py

    yrows, crows = base.stripe_h // 8, base.stripe_h // 16
    tally = {"frames": len(kept), "stripes": 0, "host_coded": 0,
             "mismatch": 0}
    t0 = time.perf_counter()
    for scans, emit, ovf, yq, cbq, crq in kept:
        with base.stream_context():
            y, cb, cr = (t.cpu().numpy() for t in (yq, cbq, crq))
        for s in np.flatnonzero(emit):
            want = entropy_py.encode_scan_420(
                y[s * yrows:(s + 1) * yrows], cb[s * crows:(s + 1) * crows],
                cr[s * crows:(s + 1) * crows])
            tally["stripes"] += 1
            tally["host_coded"] += int(ovf[s])
            tally["mismatch"] += int(scans[s] != want)
    tally["check_s"] = time.perf_counter() - t0
    return tally


def _pipeline():
    from selkies_tpu_torch.encoder.async_driver import AsyncEncodeDriver
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder
    from selkies_tpu_torch.encoder.pipeline import PipelinedJpegEncoder

    base = JpegStripeEncoder(W, H, stripe_height=STRIPE, device=DEVICE)
    pipe = PipelinedJpegEncoder(base, depth=4, fetch_group=2)
    return base, pipe, AsyncEncodeDriver(pipe)


def _overflow_run():
    """Two 1080p desktop frames with a band of noise over stripes 5 and 6:
    those overflow the device packer's budget and are host-coded, the rest
    are device-packed; every stripe of both frames is checked."""
    from selkies_tpu_torch.capture.synthetic import SyntheticSource

    desk = SyntheticSource(W, H, pattern="desktop", seed=4)
    base, pipe, drv = _pipeline()
    kept = _recording(base)
    for seed in (8, 9):
        f = desk.next_frame().copy()
        noise = SyntheticSource(W, H, pattern="noise", seed=seed).next_frame()
        f[5 * STRIPE:7 * STRIPE] = noise[5 * STRIPE:7 * STRIPE]
        check(drv.try_submit(f) is not None, "submit refused")
    results = drv.flush()
    st = drv.stats()
    drv.close()
    drv.join(30.0)
    check(len(results) == 2 and st["encode_errors"] == 0,
          f"overflow run: {len(results)} of 2 frames, {st}")
    tally = _check_recorded(base, kept)
    check(tally["mismatch"] == 0 and tally["host_coded"] >= 2
          and tally["stripes"] > tally["host_coded"],
          f"overflow run: scans vs entropy_py {tally}")
    check(st["host_fallback_stripes"] == tally["host_coded"],
          f"overflow run: {st['host_fallback_stripes']} host-coded stripes, "
          f"{tally['host_coded']} checked")
    return {"frames": 2, "checked_stripes": tally["stripes"],
            "checked_host_coded": tally["host_coded"],
            "host_fallback_stripes": st["host_fallback_stripes"],
            "check_s": tally["check_s"]}, pipe._seq


def _reserve(base, n_frames: int) -> None:
    """Allocate, then free, ``n_frames`` frames' coefficient planes on the
    encoder's stream. The caching allocator keeps the blocks, so a timed
    run that keeps every frame's planes allocates no new device memory."""
    import torch

    if base.stream is None:
        return
    shapes = [(base.pad_h // 8, base.pad_w // 8, 64)] \
        + [(base.pad_h // 16, base.pad_w // 16, 64)] * 2
    with base.stream_context():
        held = [torch.empty(shape, dtype=torch.int16, device=base.device)
                for _ in range(n_frames) for shape in shapes]
    del held


def phase_encoder():
    """1920x1080 through PipelinedJpegEncoder + AsyncEncodeDriver over the
    desktop and scroll patterns, N_FRAMES timed frames each. The timed run
    keeps every frame's scans and coefficient planes (references into
    memory reserved beforehand); after the window, every stripe scan must
    equal entropy_py on its frame's own coefficients fetched from the card.
    Last, a short run whose noise stripes are host-coded, all checked."""
    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag

    out = {"phase": "encoder", "width": W, "height": H, "patterns": {}}
    dispatched = 0
    for pattern in ("desktop", "scroll"):
        src = SyntheticSource(W, H, pattern=pattern, seed=2)
        frames = [src.next_frame() for _ in range(N_FRAMES)]
        base, pipe, drv = _pipeline()
        kept = _recording(base)
        drv.try_submit(frames[0])            # first step builds scratch
        drv.flush()
        _reserve(base, N_FRAMES)
        launches0 = dct8_quant_zigzag.launches
        t0 = time.perf_counter()
        results = []
        for f in frames:
            while drv.try_submit(f) is None:  # queue full: wait, never drop
                time.sleep(0.0005)
            results += drv.poll()
        results += drv.flush()
        wall = time.perf_counter() - t0
        st = drv.stats()
        drv.close()
        drv.join(30.0)
        dispatched += pipe._seq
        check(len(results) == N_FRAMES and st["encode_errors"] == 0,
              f"{pattern}: {len(results)} of {N_FRAMES} frames, {st}")
        tally = _check_recorded(base, kept)
        # _scans_from_packed runs for every frame that emits a stripe
        # (the warm-up frame included)
        coded = 1 + sum(1 for _, stripes in results if stripes)
        check(tally["frames"] == coded and tally["mismatch"] == 0,
              f"{pattern}: {coded} frames coded; scans vs entropy_py {tally}")
        out["patterns"][pattern] = {
            "checked_frames": tally["frames"],
            "checked_stripes": tally["stripes"],
            "checked_host_coded": tally["host_coded"],
            "check_s": tally["check_s"],
            "frames": N_FRAMES,
            "fps": N_FRAMES / wall,
            "stripes_per_frame": sum(len(s) for _, s in results) / N_FRAMES,
            "dispatch_p50_ms": st["dispatch_p50_ms"],
            "fetch_wait_p50_ms": st["fetch_wait_p50_ms"],
            "d2h_bytes_per_frame": st["d2h_bytes_per_frame"],
            "host_entropy_ms_per_frame": st["host_entropy_ms_per_frame"],
            "host_fallback_stripes": st["host_fallback_stripes"],
            "inflight_batches_max": st["inflight_batches_max"],
            "kernel_launches": dct8_quant_zigzag.launches - launches0,
        }
    out["overflow"], n = _overflow_run()
    out["frames_dispatched"] = dispatched + n
    return out


def phase_profile(n_frames: int = 30):
    """Where a frame's time goes on the card: torch.profiler over a steady
    window of the pipelined 1080p scroll encode (every stripe damaged).
    Device busy share is the union of device intervals over the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from selkies_tpu_torch.capture.synthetic import SyntheticSource

    src = SyntheticSource(W, H, pattern="scroll", seed=3)
    frames = [src.next_frame() for _ in range(n_frames + 10)]
    base, pipe, drv = _pipeline()
    for f in frames[:10]:                   # warm: allocator, first steps
        while drv.try_submit(f) is None:
            time.sleep(0.0005)
    drv.flush()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[10:]:
            while drv.try_submit(f) is None:
                time.sleep(0.0005)
        drv.flush()
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    drv.close()
    drv.join(30.0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(dev), "profiler recorded no device events")
    out = {"phase": "profile", "pattern": "scroll", "frames": n_frames,
           "wall_ms_per_frame": wall_us / 1e3 / n_frames}
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in dev:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    total_us = sum(v[1] for v in by_name.values())
    dct_us = sum(v[1] for k, v in by_name.items() if "dct8_quant_zigzag" in k)
    copy_us = sum(v[1] for k, v in by_name.items() if "Memcpy" in k or "Memset" in k)
    htod_us = sum(v[1] for k, v in by_name.items() if "Memcpy HtoD" in k)
    out.update({
        "device_ms_per_frame": total_us / 1e3 / n_frames,
        "device_busy_share": busy / max(1.0, window),
        "device_idle_share": 1.0 - busy / max(1.0, window),
        "device_ops_per_frame": len(dev) / n_frames,
        "dct_kernel_ms_per_frame": dct_us / 1e3 / n_frames,
        "copies_ms_per_frame": copy_us / 1e3 / n_frames,
        "htod_ms_per_frame": htod_us / 1e3 / n_frames,
        "top_device_ops": [
            {"name": k[:80], "calls_per_frame": v[0] / n_frames,
             "ms_per_frame": v[1] / 1e3 / n_frames} for k, v in top[:8]],
    })
    return out


def phase_small_reference():
    """A small frame sequence encoded on the card and on the CPU (the CPU
    bytes are the ones the tests hold equal to the JAX package's)."""
    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder

    kw = dict(stripe_height=STRIPE, paintover_quality=95,
              paint_over_trigger_frames=2)
    gpu = JpegStripeEncoder(256, 120, device=DEVICE, **kw)
    cpu = JpegStripeEncoder(256, 120, device="cpu", **kw)
    src = SyntheticSource(256, 120, pattern="desktop", seed=6)
    frames = [src.next_frame() for _ in range(3)]
    frames += [frames[-1]] * 4
    frames.append(SyntheticSource(256, 120, pattern="noise", seed=7).next_frame())
    same = total = 0
    for f in frames:
        a, b = gpu.encode_frame(f), cpu.encode_frame(f)
        check([s.y_start for s in a] == [s.y_start for s in b],
              "card and CPU emitted different stripes")
        total += len(a)
        same += sum(x.jpeg == y.jpeg for x, y in zip(a, b))
    check(same == total, f"card vs CPU stripe bytes: {same} of {total} equal")
    return {"small_frames": len(frames), "small_stripes_identical": same}


def phase_server(min_frames: int = 30, timeout_s: float = 180.0):
    """An in-process client through the port's ws_handler at 1920x1080:
    SETTINGS handshake, >= min_frames frames of 0x03 stripes, each ACKed."""
    from selkies_tpu_torch.protocol.wire import unpack_binary
    from selkies_tpu_torch.server.data_server import DataStreamingServer
    from selkies_tpu_torch.settings import Settings

    class Client:
        def __init__(self):
            self.sent = []
            self.closed = False
            self.q = asyncio.Queue()

        async def send(self, m):
            self.sent.append(m)

        def send_nowait(self, m):
            if not self.closed:
                self.sent.append(m)

        async def close(self):
            if not self.closed:
                self.closed = True
                self.q.put_nowait(None)

        def __aiter__(self):
            return self

        async def __anext__(self):
            m = await self.q.get()
            if m is None:
                raise StopAsyncIteration
            return m

    async def run():
        settings = Settings(argv=[], env={"SELKIES_PORT": "0"})
        server = DataStreamingServer(settings, device=DEVICE)
        ws = Client()
        task = asyncio.create_task(server.ws_handler(ws))
        ws.q.put_nowait("SETTINGS," + json.dumps({
            "displayId": "primary", "initialClientWidth": W,
            "initialClientHeight": H, "framerate": 60}))
        acked, seen, stripes, nbytes = set(), 0, 0, 0
        t0 = time.monotonic()
        first_frame_s = None
        while len(acked) < min_frames and time.monotonic() - t0 < timeout_s:
            await asyncio.sleep(0.005)
            for m in ws.sent[seen:]:
                if isinstance(m, (bytes, bytearray)):
                    f = unpack_binary(bytes(m))
                    check(m[0] == 0x03 and f.payload[:2] == b"\xff\xd8"
                          and f.payload[-2:] == b"\xff\xd9", "bad 0x03 stripe")
                    stripes += 1
                    nbytes += len(m)
                    if f.frame_id not in acked:
                        if first_frame_s is None:
                            first_frame_s = time.monotonic() - t0
                        acked.add(f.frame_id)
                        ws.q.put_nowait(f"CLIENT_FRAME_ACK {f.frame_id}")
            seen = len(ws.sent)
        await asyncio.sleep(0.2)
        st = server.display_clients["primary"]
        result = {
            "phase": "server", "width": W, "height": H,
            "mode": ws.sent[0] if ws.sent else None,
            "frames_received": len(acked), "stripes_received": stripes,
            "bytes_received": nbytes,
            "acknowledged_frame_id": st.bp.acknowledged_frame_id,
            "send_enabled": st.bp.send_enabled,
            "first_frame_s": first_frame_s,
            "frames_per_s_after_first": (
                (len(acked) - 1) / (time.monotonic() - t0 - first_frame_s - 0.2)
                if first_frame_s is not None and len(acked) > 1 else None),
        }
        await ws.close()
        await asyncio.wait_for(task, 30.0)
        await server.stop()
        return result

    res = asyncio.run(run())
    check(res["mode"] == "MODE websockets", "handshake")
    check(res["frames_received"] >= min_frames,
          f"server sent {res['frames_received']} frames < {min_frames}")
    check(res["acknowledged_frame_id"] >= min_frames, "ACKs not taken")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import selkies_tpu_torch  # noqa: F401  (absent beside a lone script)
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag

    t_start = time.perf_counter()
    phase_setup()
    kern = phase_kernel_check()

    # the main path: launch counts from 0 just before it, read just after
    dct8_quant_zigzag.launches = 0
    enc = phase_encoder()
    enc_launches = dct8_quant_zigzag.launches
    check(enc_launches == 3 * enc["frames_dispatched"],
          f"{enc_launches} kernel launches for {enc['frames_dispatched']} "
          "frames (3 per frame expected)")
    enc["kernel_launches_per_frame"] = enc_launches / enc["frames_dispatched"]
    server = phase_server()
    launches = dct8_quant_zigzag.launches
    server["kernel_launches"] = launches - enc_launches
    check(server["kernel_launches"] >= 3 * server["frames_received"],
          "server path did not run the kernel for every frame")
    kern["launches"] = launches
    check(launches > 0, "the main path never launched dct8_quant_zigzag")
    enc.update(phase_small_reference())
    prof = phase_profile()

    emit({"kernels": [kern]})
    emit(enc)
    emit(server)
    emit(prof)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
