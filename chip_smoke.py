#!/usr/bin/env python3
"""Drive the PyTorch port (selkies_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py            # from the root of a checkout, one card
    python3 chip_smoke.py --dct-planes-of DIR
        # device time of each launch that DIR's checkout of the port makes
        # for one 1080p frame's DCT (an older tree's per-plane launches)
    python3 chip_smoke.py --served-against DIR [PAIRS]
        # the served phases of this checkout and of DIR's, alternating
        # in one call, PAIRS of each (default 2; first frame after
        # SETTINGS, frames/s)

It builds the port's CUDA kernels (and the g++ host coders: H.264 CAVLC and
the JPEG scan) from the checkout's sources, holds each kernel against its
plain PyTorch version at the 1080p main-path shapes (the motion kernel at
the striped and the full-frame shape), and drives every served profile at
1920x1080: the JPEG-stripe profile (pipelined encoder behind the async
driver, then the data server's ws_handler with an in-process client), the
x264enc-striped and the full-frame x264enc H.264 profiles (the same two
ways), the host-entropy rung of both codecs (behind the threaded
adapter), batched H.264 dispatch (4 and BATCH frames per step through
``submit_batch``, frames made on the card by DeviceScrollSource, against
one frame per step, both profiles, with each run's memory peak, and the
host tier; the data server with SELKIES_TPU_ASYNC_BATCH=4), the JPEG
pipeline fed with frames made on the card against the same frames from
the host, and a served x264enc-striped display walked down the
degradation ladder and back up by injected faults, then restarted by its
watchdog (``server_faults``; each unfaulted served phase must end at the
device rung with no failure and no restart, so a kernel that fails to
build or launch fails the script instead of turning into a stream from a
lower rung). Launch counters,
set to 0 before each path and read after it,
show that the path ran its kernel. Each timed device-rung encoder run is
made twice: once keeping nothing (its rates are the ones reported) and
once keeping what the check after its window needs (its rates are
reported beside them). The output is checked by the repo's own means:

* JPEG: every stripe scan of each checked run equals the host coder
  (entropy_py) on that frame's coefficients fetched from the card; a 1080p
  run with overflowed (host-coded) noise stripes is checked the same way;
  a small sequence encoded on the card equals it encoded on the CPU;
* H.264 (both profiles): on every CHECK_EVERY-th P frame of each checked
  run, every emitted stripe's device-CAVLC Annex-B equals the native coder
  (encode_picture_nals_np) on that stripe's exact levels, kept on the
  card; the entropy error count stays 0; and a 1920x256 sequence (IDR,
  scrolled P frames, paint-over, a keyframe request) encoded on the card
  equals it encoded on the CPU, whose bytes the CPU tests hold equal to
  the JAX package's, striped and full-frame, with each entropy tier; a
  1080p noise P frame at QP 18 through x264enc, whose payload passes the
  fetch prefix (device tier) and whose nonzero cells pass the cap and wrap
  the u16 head count (host tier), equals the native coder on its levels;
* the host rungs: every frame's stripes equal the device rung's,
  encoded synchronously on the card from the same frames;
* batched dispatch: every frame's stripes equal those of one frame per
  dispatch over the same frames on the card (the host tier's too);
  JPEG with frames made on the card: every stripe equals the host-frame
  runs'.

Encoders share one CUDA stream per card, so the memory of a closed
encoder goes back to the allocator's pool: the encoder_churn phase builds,
uses and closes eight encoders of each profile in turn and checks that
the reserved memory stops growing.

Multi-session lanes (``parallel/``): ``mesh_encoder`` drives one lane of
4 and of 8 sessions at 1080p per profile (JPEG; x264enc-striped on the
device tier at 4 and 8, on the host tier at 4) with frames made on the
card, each session its own, one idle: every session's checked bytes equal
its own solo encoder's, one kernel launch per tick, rates, device ops per
tick and the lane's memory peak beside the solo encoder's figures; and
``server_mesh`` serves four x264enc-striped displays from one lane through
``ws_handler``, sheds a fifth with KILL server_full, and migrates one
display off a slot faulted by ``mesh.slot_raise`` while the others keep
streaming. Both kernels are held against their plain versions at the
lanes' shapes too.

The client plane: ``server_resize`` walks each served profile from
1920x1080 to 1366x768, 2560x1440 and back, twice, then through a storm of
20 resizes: every geometry's frame 1 equals a fresh encoder's, the kernel
is launched for every frame (P frame) there, the storm costs at most 2
reconfigurations, and the reserved memory stays flat; a lane display
moves bucket and back while its cohabitants stream, and the drained
bucket retires. ``server_edge`` evicts a stalled viewer, kills an abuser
and takes a 64 MiB upload while a JPEG display streams, and reads the
stats feed's ``gpu_stats``. Both kernels are held against their plain
versions at the resized displays' shapes too.

The other planes: ``server_trace`` serves each profile and a lane of
four x264enc-striped displays with the flight recorder and the metrics
plane wired as ``main()`` wires them: every ACKed frame's stages
(capture, stage, dispatch, fetch_wait, pack, queue, send, ack) in time
order, no span open after the display stops, ``/healthz``,
``/debug/trace`` and ``/metrics`` answered, the client's
``system_health`` with ``stages``, and a 300 ms ``torch.profiler``
request on the trace route whose trace holds the path's kernel. It runs
last: its profiler must not overlap the timing phases' windows.

The WebRTC mode: ``webrtc`` streams the port's WebRTCStreamingApp at
1920x1080 and 60 fps (one H.264 stripe over the frame, pipelined) to a
browser stand-in PeerConnection on 127.0.0.1 over ICE and DTLS-SRTP
(without ``cryptography``, through the H.264 payloader and depayloader
alone): every access unit that arrives equals the one the app sent and a
fresh encoder's over the frames the app dispatched, QP 34 from the frame
whose source set 2 Mbps, an IDR right after a PLI, the reserved memory
flat over two more start/stop cycles. The motion kernel is held against
its plain version at the WebRTC entry point's default 1280x720 stripe
too.

The harnesses (``selkies_tpu_torch/tools/``): ``harnesses`` runs the
CAVLC fuzzer's device mode on the card (random geometries, and the 1080p
striped and full-frame shapes with the served encoder's stripe
capacity: every unflagged stripe bit-exact, every overflow flagged), a
1080p fault storm of chaos_run solo, on a lane and on an SFE lane of two
shards (alive, no span or slot leaked, the JPEG kernel launched during
each, by device for SFE), and swarm_run over the port's real lane
encoders (leak-free, its sick slot's session migrated, no cohabitant
stalled).

It prints one JSON object per line (setup, server_resize, server_edge,
webrtc and the harnesses' parts as they end, then kernels, encoder,
h264_encoder, h264_fullframe_encoder, host_rung, server, server_h264,
server_fullframe, h264_batch, server_h264_batch, server_faults,
mesh_encoder, server_mesh, jpeg_device_frames, encoder_churn, h264_cross,
profile, profile_h264, profile_fullframe, server_trace, total),
the card's name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result. It imports neither jax nor selkies_tpu, and
needs neither websockets, prometheus_client, an X server nor PIL.
"""

from __future__ import annotations

import asyncio
import contextlib
import faulthandler
import functools
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and f32
#: non-tensor-core FLOP/s, for the bound of a kernel's work
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: INT32 lanes of the H100 SXM: 132 SMs x 64; the integer peak is this
#: times the SM clock nvidia-smi reports as the card's maximum. The byte
#: SIMD instructions (VABSDIFF4, IDP.4A) each do four byte operations per
#: lane; the bound counts them at this same full rate, the most the card
#: could issue
INT32_LANES = 132 * 64

W, H = 1920, 1080
STRIPE = 64
#: frames in each timed encoder run (JPEG, H.264, each host rung)
N_FRAMES = 120
N_H264 = 90
N_HOST = 40
#: every CHECK_EVERY-th H.264 P frame of a timed run is checked stripe by
#: stripe against the native coder on its exact levels
CHECK_EVERY = 5
#: where the port runs (a CPU rehearsal of the phases may set "cpu")
DEVICE = "cuda"
#: sessions per lane measured by mesh_encoder and held at the lane shapes
#: by the kernel checks
MESH_SIZES = (4, 8)
#: the geometries server_resize walks a 1080p display through (1366 pads
#: to 1376: 10 whole 128-pixel tiles of the motion kernel and a partial
#: one), held at their shapes by the kernel checks
RESIZE_GEOMS = ((1366, 768), (2560, 1440))


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


#: profiler windows taken again because CUPTI lost device records, and
#: the timings that fell back to CUDA events (reported in the kernels line)
PROFILER = {"retries": 0, "fell_back_to_events": []}


def _device_events(fn, reps: int):
    """The device events torch.profiler records over ``reps`` back-to-back
    runs of ``fn()`` (after one unprofiled run), in issue order."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def launch_ms(fn, reps: int, tries: int = 5):
    """Device time of each launch ``fn()`` makes, in issue order (a list:
    torch.profiler's device intervals, the i-th of every run averaged over
    ``reps`` back-to-back runs, warm L2 as on the main path, where the
    inputs were written just before; each run must make the same
    launches). Unlike CUDA events around the calls it excludes the gaps in
    which the device waits for the host to enqueue the next launch.

    CUPTI now and then loses some of a window's device records, so a
    window is kept only when it holds ``reps`` times the events of a
    one-run window taken just before it; else both are taken again, at
    most ``tries`` times, and None is returned."""
    for attempt in range(tries):
        per = len(_device_events(fn, 1))
        dev = _device_events(fn, reps)
        if per and len(dev) == per * reps:
            PROFILER["retries"] += attempt
            return [sum(e.time_range.elapsed_us() for e in dev[i::per])
                    / 1e3 / reps for i in range(per)]
    PROFILER["retries"] += tries
    return None


def device_ms(fn, reps: int, what: str):
    """Device time of ``fn()`` per run and how it was taken: its launches'
    times summed (torch.profiler); where the profiler lost records in
    every try, CUDA events around each run (launch gaps included)."""
    per = launch_ms(fn, reps)
    if per is not None:
        return sum(per), "torch.profiler"
    PROFILER["fell_back_to_events"].append(what)
    return cuda_time_ms(fn, reps), "CUDA events"


#: what each _settle call found and freed, by the phase it ran before,
#: and when (seconds since the script started)
SETTLED = {}
T_START = time.perf_counter()

#: name prefixes of the threads the port starts: encoder drivers and
#: threaded adapters, the lane ticker, the audio capture, the metrics
#: HTTP server. (The H.264 entropy pool's "cavlc" workers are one pool
#: per process, kept for its life and joined at exit by
#: concurrent.futures.)
PORT_THREADS = ("torchenc", "mesh-encode", "selkies-", "metrics-http")
#: seconds a phase's threads get to end after it returned
THREAD_GRACE_S = 10.0


def check_no_port_threads(after: str) -> None:
    """No thread the port started is alive once the phase that started it
    has returned (each gets THREAD_GRACE_S to end): one left running at
    process exit may be inside a device call while CUDA is torn down."""
    deadline = time.monotonic() + THREAD_GRACE_S
    while True:
        left = [t for t in threading.enumerate()
                if t.is_alive() and t.name.startswith(PORT_THREADS)]
        if not left or time.monotonic() >= deadline:
            break
        left[0].join(timeout=0.1)
    check(not left, f"threads left running after {after}: "
          f"{sorted(t.name for t in left)}")


def _settle(before: str) -> None:
    """Check that the earlier phases left no thread of the port running,
    free the Python garbage they left in reference cycles (torch.profiler's
    event trees) before a timed phase, and record the CUDA allocator's
    reserved memory there. The allocator's cache is left as it is: every
    encoder allocates on its device's one encoder stream, so a closed
    encoder's blocks are reused by the next one."""
    import gc

    import torch

    check_no_port_threads(f"the phases before {before}")
    reserved = torch.cuda.memory_reserved() if DEVICE == "cuda" else 0
    SETTLED[before] = {"gc_freed": gc.collect(),
                       "reserved_mb_before": reserved >> 20,
                       "at_s": time.perf_counter() - T_START}


# ---------------------------------------------------------------------------
# phases


def phase_setup():
    """Build every kernel of the checkout (one nvcc per source) and the two
    host coders (g++), all at once; print the card's name and power limit.
    Returns the card's maximum SM clock in Hz (for integer peaks)."""
    import torch

    from selkies_tpu_torch import _build
    from selkies_tpu_torch.native import cavlc_lib, entropy_lib

    def smi(query):
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        lines = out.splitlines()
        return lines[torch.cuda.current_device()] if lines else "unknown"

    card = smi("name,power.limit")
    CARD["name_power"] = card
    print(card, flush=True)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    stems = sorted(p[:-3] for p in os.listdir(_build.CSRC) if p.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(stems) + 2) as pool:  # one nvcc per source
        host = [pool.submit(cavlc_lib), pool.submit(entropy_lib)]
        list(pool.map(_build.load_library, stems))
        for h in host:
            h.result()
    build_s = time.perf_counter() - t0
    SASS.update({stem: _build.sass_opcodes(_build.libraries[stem])
                 for stem in stems})
    emit({"phase": "setup", "gpu": card, "max_sm_clock_mhz": clock_mhz,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels_built": stems,
          "host_coders_built": ["native/cavlc.cpp", "native/entropy.cpp"],
          "build_s": round(build_s, 3),
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in _build.ptxas_report.items()},
          "sass_opcodes": SASS})
    return clock_mhz * 1e6


#: SASS opcode counts of each built kernel, by source stem (phase_setup)
SASS = {}
#: the card's name and power limit as nvidia-smi gives them (phase_setup)
CARD = {}


def _main_path_planes(frame_np, enc):
    """The Y, Cb, Cr planes and band table indices the main path hands the
    kernel for one frame (the encoder's own color/4:2:0 on the card)."""
    import torch

    from selkies_tpu_torch.ops.color import rgb_to_ycbcr, subsample_420

    f = torch.from_numpy(enc._pad(frame_np)).to(enc.device)
    y, cb, cr = rgb_to_ycbcr(f)
    cb, cr = subsample_420(cb), subsample_420(cr)
    qsel = torch.arange(enc.n_stripes, device=enc.device, dtype=torch.int32) % 2
    row_y = qsel[torch.arange(y.shape[0] // 8, device=enc.device) // (STRIPE // 8)]
    row_c = qsel[torch.arange(cb.shape[0] // 8, device=enc.device) // (STRIPE // 16)]
    return [(y, enc._recip_y, row_y), (cb, enc._recip_c, row_c),
            (cr, enc._recip_c, row_c)]


def _lane_planes(frames, enc):
    """The planes a JPEG lane's tick hands the kernel for N sessions'
    frames (``encode_body_sessions``: the session axis folded into the
    rows, [N*1088, 1920] and [N*544, 960]), with q40/q90 bands alternating
    by (session, stripe)."""
    import torch

    from selkies_tpu_torch.ops.color import rgb_to_ycbcr, subsample_420

    dev = enc.device
    f = torch.stack([torch.from_numpy(enc._pad(x)) for x in frames]).to(dev)
    n = f.shape[0]
    y, cb, cr = rgb_to_ycbcr(f.reshape(n * enc.pad_h, enc.pad_w, 3))
    cb, cr = subsample_420(cb), subsample_420(cr)
    qsel = torch.arange(n * enc.n_stripes, device=dev,
                        dtype=torch.int32) % 2
    row_y = qsel[torch.arange(y.shape[0] // 8, device=dev) // (STRIPE // 8)]
    row_c = qsel[torch.arange(cb.shape[0] // 8, device=dev)
                 // (STRIPE // 16)]
    return [(y, enc._recip_y, row_y), (cb, enc._recip_c, row_c),
            (cr, enc._recip_c, row_c)]


def _dct_at_lane(enc, n: int) -> dict:
    """dct8_quant_zigzag at a lane's shape (N sessions folded into the
    rows: one launch for every session's three planes) against its plain
    version, exactly (max |diff| 0), on N different scroll and noise
    frames; kernel, plain and library times and the bound."""
    import torch

    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.ops import dct as tdct
    from selkies_tpu_torch.ops.dct_quant import (dct8_quant_zigzag,
                                                 dct8_quant_zigzag_plain)

    sets = {
        "scroll": [SyntheticSource(W, H, pattern="scroll", seed=10 + k)
                   .next_frame() for k in range(n)],
        "noise": [SyntheticSource(W, H, pattern="noise", seed=20 + k)
                  .next_frame() for k in range(n)],
    }
    max_err = n_coef = 0
    for frames in sets.values():
        planes = _lane_planes(frames, enc)
        l0 = dct8_quant_zigzag.launches
        outs = dct8_quant_zigzag(planes)
        check(dct8_quant_zigzag.launches == l0 + 1,
              f"lane of {n}: the planes took more than one launch")
        for got, (plane, recip, row) in zip(outs, planes):
            want = dct8_quant_zigzag_plain(plane, recip, row)
            torch.cuda.synchronize()
            max_err = max(max_err,
                          int((got.int() - want.int()).abs().max().item()))
            n_coef += got.numel()
    shape = "[%d,%d]+2x[%d,%d]" % (planes[0][0].shape + planes[1][0].shape)
    check(max_err == 0, f"dct8 kernel vs plain at the lane shape {shape}: "
          f"max |diff| {max_err}")
    planes = _lane_planes(sets["noise"], enc)
    kernel_ms, how = device_ms(lambda: dct8_quant_zigzag(planes), 50,
                               f"dct8_quant_zigzag/lane{n}")
    plain_ms, plain_how = device_ms(
        lambda: [dct8_quant_zigzag_plain(*p) for p in planes], 3,
        f"dct8_quant_zigzag/lane{n}/plain")
    blocks = [tdct.blockify(p) - 128.0 for p, _, _ in planes]
    library_ms, library_how = device_ms(
        lambda: [tdct.block_dct2_einsum(b) for b in blocks], 20,
        f"dct8_quant_zigzag/lane{n}/library")
    in_bytes = sum(p.numel() * 4 + r.numel() * 4 + i.numel() * 4
                   for p, r, i in planes)
    out_bytes = sum(p.numel() * 2 for p, _, _ in planes)
    flops = sum(p.numel() // 64 for p, _, _ in planes) \
        * (2 * 64 * 8 * 2 + 64 + 64)
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    return {"sessions": n, "shape": shape, "max_abs_err": max_err,
            "n_coeffs": n_coef, "ms": kernel_ms,
            "ms_timing": f"{how} device time, warm L2, 50 reps",
            "plain_ms": plain_ms, "plain_timing": plain_how,
            "library_ms": library_ms, "library_timing": library_how,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "unit": f"one lane tick of {n} 1080p frames, 1 launch"}


def _dct_at_geometry(w: int, h: int) -> dict:
    """dct8_quant_zigzag at the planes a served display of ``w`` x ``h``
    hands it (the JPEG encoder's padding: width to a multiple of 16,
    height to whole stripes), one launch for Y, Cb and Cr, against its
    plain version exactly (max |diff| 0) on a scroll, a noise and a
    desktop frame; kernel, plain and library times and the bound."""
    import torch

    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder
    from selkies_tpu_torch.ops import dct as tdct
    from selkies_tpu_torch.ops.dct_quant import (dct8_quant_zigzag,
                                                 dct8_quant_zigzag_plain)

    enc = JpegStripeEncoder(w, h, stripe_height=STRIPE, device=DEVICE)
    max_err = n_coef = 0
    for pattern, seed in (("scroll", 30), ("noise", 31), ("desktop", 32)):
        planes = _main_path_planes(
            SyntheticSource(w, h, pattern=pattern, seed=seed).next_frame(),
            enc)
        l0 = dct8_quant_zigzag.launches
        outs = dct8_quant_zigzag(planes)
        check(dct8_quant_zigzag.launches == l0 + 1,
              f"{w}x{h}: the planes took more than one launch")
        for got, (plane, recip, row) in zip(outs, planes):
            want = dct8_quant_zigzag_plain(plane, recip, row)
            torch.cuda.synchronize()
            max_err = max(max_err,
                          int((got.int() - want.int()).abs().max().item()))
            n_coef += got.numel()
    shape = "[%d,%d]+2x[%d,%d]" % (planes[0][0].shape + planes[1][0].shape)
    check(max_err == 0, f"dct8 kernel vs plain at {w}x{h} {shape}: "
          f"max |diff| {max_err}")
    kernel_ms, how = device_ms(lambda: dct8_quant_zigzag(planes), 100,
                               f"dct8_quant_zigzag/{w}x{h}")
    plain_ms, plain_how = device_ms(
        lambda: [dct8_quant_zigzag_plain(*p) for p in planes], 5,
        f"dct8_quant_zigzag/{w}x{h}/plain")
    blocks = [tdct.blockify(p) - 128.0 for p, _, _ in planes]
    library_ms, library_how = device_ms(
        lambda: [tdct.block_dct2_einsum(b) for b in blocks], 50,
        f"dct8_quant_zigzag/{w}x{h}/library")
    in_bytes = sum(p.numel() * 4 + r.numel() * 4 + i.numel() * 4
                   for p, r, i in planes)
    out_bytes = sum(p.numel() * 2 for p, _, _ in planes)
    flops = sum(p.numel() // 64 for p, _, _ in planes) \
        * (2 * 64 * 8 * 2 + 64 + 64)
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {"shape": shape, "max_abs_err": max_err, "n_coeffs": n_coef,
            "ms": kernel_ms,
            "ms_timing": f"{how} device time, warm L2, 100 reps",
            "plain_ms": plain_ms, "plain_timing": plain_how,
            "library_ms": library_ms, "library_timing": library_how,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": bound_ms / kernel_ms,
            "unit": f"one {w}x{h} frame: Y, Cb, Cr, 1 launch"}


def phase_kernel_check():
    """dct8_quant_zigzag (one launch for a frame's three planes) against
    its plain version, plane by plane, at the 1080p shapes, q40/q90 bands
    alternating by stripe; then kernel, plain and library (one
    torch.einsum DCT) times, the kernel's time when it is called once per
    plane, and the bound of the work. ``lane_shapes``: the same at the
    shapes of a JPEG lane's tick of MESH_SIZES sessions; ``resize_shapes``
    the same at each RESIZE_GEOMS frame's padded planes."""
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
        planes = _main_path_planes(frame, enc)
        launches0 = dct8_quant_zigzag.launches
        outs = dct8_quant_zigzag(planes)
        check(dct8_quant_zigzag.launches == launches0 + 1,
              "three planes took more than one launch")
        for got, (plane, recip, row) in zip(outs, planes):
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
        dct8_quant_zigzag(planes)

    def plain():
        for p, r, i in planes:
            dct8_quant_zigzag_plain(p, r, i)

    blocks = [tdct.blockify(p) - 128.0 for p, _, _ in planes]

    def library():
        for b in blocks:
            tdct.block_dct2_einsum(b)

    flush = flush_buf.zero_
    kernel_ms, kernel_how = device_ms(kernel, 100, "dct8_quant_zigzag")
    per_plane = [device_ms(lambda p=p: dct8_quant_zigzag([p]), 100,
                           f"dct8_quant_zigzag/plane{i}")
                 for i, p in enumerate(planes)]
    plain_ms, plain_how = device_ms(plain, 10, "dct8_quant_zigzag/plain")
    library_ms, library_how = device_ms(library, 50,
                                        "dct8_quant_zigzag/library")
    # CUDA events around the call, L2 overwritten before each: the
    # host-visible cost, launch gap included
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
        "ms_timing": f"{kernel_how} device time, warm L2, 100 reps",
        "plain_timing": plain_how,
        "library_timing": library_how,
        "events_ms_cold_l2": events_cold_ms,
        "per_plane_launch_ms": [ms for ms, _ in per_plane],
        "per_plane_timing": [how for _, how in per_plane],
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "library_call": "torch.einsum('ij,...jk,lk->...il') DCT only, f32",
        "unit": "one 1080p frame: Y 1088x1920 + Cb, Cr 544x960, 1 launch",
        "bytes": in_bytes + out_bytes,
        "flops": flops,
        "lane_shapes": {f"N{n}": _dct_at_lane(enc, n) for n in MESH_SIZES},
        "resize_shapes": {f"{w}x{h}": _dct_at_geometry(w, h)
                          for w, h in RESIZE_GEOMS},
        # multi_device's per-shard launches: a session:2 lane of 8 gives
        # each device the lane_shapes N4 planes; an SFE shard of a
        # 3840x2160 frame over stripe:2 is one 1088-row band
        "shard_shapes": {
            "session:2 lane of 8, per device": "lane_shapes N4",
            f"sfe {MD_SFE_W}x{MD_SFE_H} {MD_SFE_MESH}, per shard":
                _dct_at_geometry(MD_SFE_W, MD_SFE_BAND)},
    }


def _text_frames(n: int, k: int = 5, seed: int = 3600000001):
    """Frame ``k`` of ``n`` seeded text sessions (the benchmark's densest
    content, ``streambench.source``) at W x H."""
    from streambench.source import Pattern

    return [Pattern(W, H, seed + i, "text").frame(k).copy()
            for i in range(n)]


def _huffman_at(enc, n: int) -> dict:
    """huffman_pack at the shape of ``n`` sessions' stripes folded into
    the rows (the lane's one pack call a tick; n = 1 is the solo step's)
    against its plain version on the same card planes, on text and scroll
    frames at q40: nbytes, base_words and overflow equal, words equal
    outside flagged stripes (none is flagged at the stripe budget); kernel
    and plain times and the byte bound."""
    import torch

    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.encoder.device_entropy import (DeviceEntropyPacker,
                                                          huffman_pack)
    from selkies_tpu_torch.encoder.jpeg import BLOCK_WORDS, max_stripe_bytes
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag

    sets = {"text": _text_frames(n),
            "scroll": [SyntheticSource(W, H, pattern="scroll", seed=10 + k)
                       .next_frame() for k in range(n)]}
    packer = DeviceEntropyPacker(
        n * enc.pad_h, enc.pad_w, STRIPE, block_words=BLOCK_WORDS,
        max_stripe_bytes=max_stripe_bytes(STRIPE, enc.pad_w), device=DEVICE,
        sessions=n)
    planes, out = {}, {}
    for name, frames in sets.items():
        lp = _lane_planes(frames, enc)
        # the encoder's q40 band everywhere
        lp = [(p, r, torch.zeros_like(i)) for p, r, i in lp]
        planes[name] = dct8_quant_zigzag(lp)
        l0 = huffman_pack.launches
        got = packer.pack(*planes[name])
        torch.cuda.synchronize()
        check(huffman_pack.launches == l0 + 2,
              f"huffman_pack N={n}: {huffman_pack.launches - l0} launches "
              "for one call (2 expected)")
        want = packer.pack_plain(*planes[name])
        meta_equal = all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
        flagged = int(want[3].sum().item())
        words_equal = flagged == 0 and torch.equal(got[0], want[0])
        check(meta_equal and words_equal,
              f"huffman_pack vs plain at N={n} ({name}): meta equal "
              f"{meta_equal}, words equal {words_equal}, {flagged} flagged")
        out[name] = {"bytes_coded": int(want[1].sum().item()),
                     "max_stripe_bytes_coded": int(want[1].max().item()),
                     "flagged": flagged}
    pl = planes["text"]
    kernel_ms, how = device_ms(lambda: packer.pack(*pl), 50,
                               f"huffman_pack/N{n}")
    plain_ms, plain_how = device_ms(lambda: packer.pack_plain(*pl), 3,
                                    f"huffman_pack/N{n}/plain")
    in_bytes = sum(t.numel() * 2 for t in pl) + packer._kernel_tables.numel() * 4
    out_bytes = n * packer.cap_words * 4 + packer.n_stripes * (8 + 8 + 1)
    bound_ms = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    return {"sessions": n,
            "shape": "[%d,%d,64]+2x[%d,%d,64]" % (pl[0].shape[:2]
                                                 + pl[1].shape[:2]),
            "stripe_budget_bytes": packer.max_stripe_words * 4,
            "content": out, "ms": kernel_ms,
            "ms_timing": f"{how} device time (both launches), warm L2, "
                         "50 reps, text frames",
            "plain_ms": plain_ms, "plain_timing": plain_how,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "share_of_bound": bound_ms / kernel_ms,
            "bytes": in_bytes + out_bytes,
            "unit": f"one pack call of {n} 1080p frames, 2 launches"}


def phase_huffman_check():
    """The Huffman pack kernel (csrc/huffman_pack.cu) against its plain
    version on the card at the solo step's shape (one 1080p frame) and at
    a JPEG lane tick's (MESH_SIZES sessions in one call); and, at the solo
    shape, flagged stripes: a desktop frame with noise over stripes 5 and
    6 at q100 (their blocks pass the block budget), and a scroll frame
    under a budget of its median stripe (about half the stripes pass it),
    where the words are compared outside the flagged spans. Launch counts
    by path are filled from the JPEG paths' runs."""
    import numpy as np
    import torch

    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.encoder.device_entropy import DeviceEntropyPacker
    from selkies_tpu_torch.encoder.jpeg import BLOCK_WORDS, JpegStripeEncoder
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag

    enc = JpegStripeEncoder(W, H, stripe_height=STRIPE, device=DEVICE,
                            quality=40, paintover_quality=100)
    budget = enc._packer.max_stripe_words * 4

    def planes_of(frame, band):
        lp = _lane_planes([frame], enc)
        return dct8_quant_zigzag(
            [(p, r, torch.full_like(i, band)) for p, r, i in lp])

    def packer(msb):
        return DeviceEntropyPacker(enc.pad_h, enc.pad_w, STRIPE,
                                   block_words=BLOCK_WORDS,
                                   max_stripe_bytes=msb, device=DEVICE)

    banded = SyntheticSource(W, H, pattern="desktop", seed=4).next_frame()
    banded[5 * STRIPE:7 * STRIPE] = SyntheticSource(
        W, H, pattern="noise", seed=8).next_frame()[5 * STRIPE:7 * STRIPE]
    scroll = planes_of(SyntheticSource(W, H, pattern="scroll", seed=3)
                       .next_frame(), 0)
    sizes = np.sort(packer(budget).pack_plain(*scroll)[1].cpu().numpy())
    overflow = {}
    for name, planes, msb in (
            ("q100_noise_band_block_budget", planes_of(banded, 1), budget),
            ("q40_scroll_median_stripe_budget", scroll,
             int(sizes[len(sizes) // 2]) // 4 * 4)):
        pk = packer(msb)
        got = pk.pack(*planes)
        want = pk.pack_plain(*planes)
        torch.cuda.synchronize()
        meta_equal = all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
        nb, base, ovf = (t.cpu().numpy() for t in want[1:])
        keep = np.ones(pk.cap_words, bool)
        for s in np.flatnonzero(ovf):
            keep[base[s]:base[s] + min(-(-nb[s] // 4),
                                       pk.max_stripe_words)] = False
        gw = got[0].cpu().numpy()
        words_equal = bool(np.array_equal(gw[keep],
                                          want[0].cpu().numpy()[keep]))
        check(meta_equal and words_equal and 0 < ovf.sum() < len(ovf)
              and not gw[~keep].any(),
              f"huffman_pack {name}: meta equal {meta_equal}, words equal "
              f"outside flagged {words_equal}, flagged {int(ovf.sum())}")
        overflow[name] = {"stripe_budget_bytes": msb,
                          "flagged": int(ovf.sum()),
                          "words_compared": int(keep.sum())}
    return {"name": "huffman_pack", "route": "cuda",
            "source": "selkies_tpu_torch/csrc/huffman_pack.cu",
            "replaces": "no TPU kernel: selkies_tpu/encoder/"
                        "device_entropy.py:DeviceEntropyPacker.pack is XLA "
                        "tensor code (the plain version's formulation)",
            "solo": _huffman_at(enc, 1),
            "lane_shapes": {f"N{n}": _huffman_at(enc, n) for n in MESH_SIZES},
            "overflow": overflow,
            "launches_by_path": {}}


def _recording(base, n_frames: int):
    """Wrap base._scans_from_packed to keep, for each of up to ``n_frames``
    frames it codes, the scans it returned, the frame's emit and overflow
    flags and a copy of its coefficient planes on the card, in buffers
    allocated here, before any timed window: keeping them allocates
    nothing inside it. _check_recorded checks them."""
    import torch

    shapes = [(base.pad_h // 8, base.pad_w // 8, 64)] \
        + [(base.pad_h // 16, base.pad_w // 16, 64)] * 2
    with base.stream_context():
        planes = [torch.empty((n_frames,) + shape, dtype=torch.int16,
                              device=base.device) for shape in shapes]
    orig = base._scans_from_packed
    kept = []

    def wrapped(words_np, base_np, nbytes_np, ovf_np, emit, yq, cbq, crq):
        scans = orig(words_np, base_np, nbytes_np, ovf_np, emit, yq, cbq, crq)
        slot = len(kept)
        check(slot < n_frames, f"more than {n_frames} frames coded")
        with base.stream_context():
            for buf, q in zip(planes, (yq, cbq, crq)):
                buf[slot].copy_(q)
        kept.append((scans, emit.copy(), ovf_np.copy(), slot))
        return scans

    base._scans_from_packed = wrapped
    return kept, planes


def _check_recorded(base, recorded) -> dict:
    """Every kept stripe scan must equal entropy_py on that frame's own
    coefficients, fetched from the card."""
    from selkies_tpu_torch.encoder import entropy_py

    kept, planes = recorded
    yrows, crows = base.stripe_h // 8, base.stripe_h // 16
    tally = {"frames": len(kept), "stripes": 0, "host_coded": 0,
             "mismatch": 0}
    t0 = time.perf_counter()
    for scans, emit, ovf, slot in kept:
        with base.stream_context():
            y, cb, cr = (buf[slot].cpu().numpy() for buf in planes)
        for s in np.flatnonzero(emit):
            want = entropy_py.encode_scan_420(
                y[s * yrows:(s + 1) * yrows], cb[s * crows:(s + 1) * crows],
                cr[s * crows:(s + 1) * crows])
            tally["stripes"] += 1
            tally["host_coded"] += int(ovf[s])
            tally["mismatch"] += int(scans[s] != want)
    tally["check_s"] = time.perf_counter() - t0
    return tally


def _pipeline(quality: int = 40):
    from selkies_tpu_torch.encoder.async_driver import AsyncEncodeDriver
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder
    from selkies_tpu_torch.encoder.pipeline import PipelinedJpegEncoder

    base = JpegStripeEncoder(W, H, stripe_height=STRIPE, quality=quality,
                             device=DEVICE)
    pipe = PipelinedJpegEncoder(base, depth=4, fetch_group=2)
    return base, pipe, AsyncEncodeDriver(pipe)


def _overflow_run():
    """Two 1080p desktop frames at quality 90 with a band of noise over
    stripes 5 and 6: those code to ~110 KB a stripe, past the device
    packer's 61,440-byte budget of a 1920x64 stripe (at q40 they code to
    ~43 KB and fit), and are host-coded, the rest device-packed; every
    stripe of both frames is checked."""
    from selkies_tpu_torch.capture.synthetic import SyntheticSource

    desk = SyntheticSource(W, H, pattern="desktop", seed=4)
    base, pipe, drv = _pipeline(quality=90)
    try:
        kept = _recording(base, 2)
        for seed in (8, 9):
            f = desk.next_frame().copy()
            noise = SyntheticSource(W, H, pattern="noise",
                                    seed=seed).next_frame()
            f[5 * STRIPE:7 * STRIPE] = noise[5 * STRIPE:7 * STRIPE]
            check(drv.try_submit(f) is not None, "submit refused")
        results = drv.flush()
        st = drv.stats()
    finally:
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


def _timed_run(make_pipeline, frames, n_warm: int, record=None,
               profiled: bool = False):
    """A pipeline from ``make_pipeline`` behind its async driver: warm it
    with ``frames[:n_warm]``, then time the rest (waiting when the queue is
    full, never dropping). ``record(base)``, called before the warm-up,
    installs what keeps frames for a check after the window; ``profiled``
    puts the timed window under torch.profiler and adds its device share
    (``_device_share``) to the stats."""
    base, pipe, drv = make_pipeline()
    try:
        kept = record(base) if record is not None else None
        for f in frames[:n_warm]:
            drv.try_submit(f)
        drv.flush()
        prof = _profiler() if profiled else None
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        results = []
        for f in frames[n_warm:]:
            while drv.try_submit(f) is None:
                time.sleep(0.0005)
            results += drv.poll()
        results += drv.flush()
        wall = time.perf_counter() - t0
        st = drv.stats()
        if prof is not None:
            prof.__exit__(None, None, None)
            st = dict(st, **_device_share(prof, len(frames) - n_warm, wall))
    finally:
        drv.close()
        drv.join(30.0)
    return base, pipe, kept, results, wall, st


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _rates(n: int, wall: float, st: dict) -> dict:
    """fps and the pipeline's dispatch and fetch-wait medians; a host rung
    (threaded adapter) has no separate dispatch and reports the median of
    its whole synchronous encode instead."""
    out = {"fps": n / wall}
    for key in ("dispatch_p50_ms", "fetch_wait_p50_ms", "encode_p50_ms"):
        if key in st:
            out[key] = st[key]
    return out


def _wire_bytes(results, fullframe: bool = False) -> int:
    """Bytes the data server puts on the wire for these results: each
    stripe packed as it packs it (0x03, 0x04, or 0x00 for x264enc)."""
    from types import SimpleNamespace

    from selkies_tpu_torch.server.data_server import _pack_stripe

    enc = SimpleNamespace(wire_fullframe=fullframe)
    return sum(len(_pack_stripe(1, s, enc))
               for _, stripes in results for s in stripes)


def phase_encoder():
    """1920x1080 through PipelinedJpegEncoder + AsyncEncodeDriver over the
    desktop and scroll patterns, N_FRAMES timed frames each, twice: a run
    that keeps nothing gives the rates; a checked run keeps every frame's
    scans and a copy of its coefficient planes (in buffers allocated
    before it), and after its window every stripe scan must equal
    entropy_py on its frame's own coefficients fetched from the card.
    Last, a short run whose noise stripes are host-coded, all checked."""
    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag

    out = {"phase": "encoder", "width": W, "height": H, "patterns": {}}
    dispatched = 0
    for pattern in ("desktop", "scroll"):
        src = SyntheticSource(W, H, pattern=pattern, seed=2)
        frames = [src.next_frame() for _ in range(N_FRAMES)]
        frames = frames[:1] + frames         # the first step builds scratch
        launches0 = dct8_quant_zigzag.launches
        _, pipe, _, results, wall, st = _timed_run(_pipeline, frames, 1)
        launches = dct8_quant_zigzag.launches - launches0
        dispatched += pipe._seq
        check(len(results) == N_FRAMES and st["encode_errors"] == 0,
              f"{pattern}: {len(results)} of {N_FRAMES} frames, {st}")
        base, pipe, kept, results_c, wall_c, st_c = _timed_run(
            _pipeline, frames, 1,
            record=lambda b: _recording(b, N_FRAMES + 1))
        dispatched += pipe._seq
        check(len(results_c) == N_FRAMES and st_c["encode_errors"] == 0,
              f"{pattern} checked: {len(results_c)} of {N_FRAMES} frames, "
              f"{st_c}")
        tally = _check_recorded(base, kept)
        # _scans_from_packed runs for every frame that emits a stripe
        # (the warm-up frame included)
        coded = 1 + sum(1 for _, stripes in results_c if stripes)
        check(tally["frames"] == coded and tally["mismatch"] == 0,
              f"{pattern}: {coded} frames coded; scans vs entropy_py {tally}")
        out["patterns"][pattern] = {
            "frames": N_FRAMES,
            **_rates(N_FRAMES, wall, st),
            "stripes_per_frame": sum(len(s) for _, s in results) / N_FRAMES,
            "wire_bytes_per_frame": _wire_bytes(results) / N_FRAMES,
            "d2h_bytes_per_frame": st["d2h_bytes_per_frame"],
            "host_entropy_ms_per_frame": st["host_entropy_ms_per_frame"],
            "host_fallback_stripes": st["host_fallback_stripes"],
            "inflight_batches_max": st["inflight_batches_max"],
            "kernel_launches": launches,
            "checked_run": _rates(N_FRAMES, wall_c, st_c),
            "checked_frames": tally["frames"],
            "checked_stripes": tally["stripes"],
            "checked_host_coded": tally["host_coded"],
            "check_s": tally["check_s"],
        }
    out["overflow"], n = _overflow_run()
    out["frames_dispatched"] = dispatched + n
    return out


def phase_profile(make_pipeline, kernel_key: str, profile_name: str,
                  n_frames: int = 30):
    """Where a frame's time goes on the card: torch.profiler over a steady
    window of a pipelined 1080p scroll encode (every stripe damaged).
    Device busy share is the union of device intervals over the window;
    ``kernel_key`` names the hand-written kernel whose share is reported."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from selkies_tpu_torch.capture.synthetic import SyntheticSource

    src = SyntheticSource(W, H, pattern="scroll", seed=3)
    frames = [src.next_frame() for _ in range(n_frames + 10)]
    base, pipe, drv = make_pipeline()
    try:
        for f in frames[:10]:               # warm: allocator, first steps
            while drv.try_submit(f) is None:
                time.sleep(0.0005)
        drv.flush()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for f in frames[10:]:
                while drv.try_submit(f) is None:
                    time.sleep(0.0005)
            drv.flush()
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        drv.close()
        drv.join(30.0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(dev), "profiler recorded no device events")
    out = {"phase": profile_name, "pattern": "scroll", "frames": n_frames,
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
    kernel_us = sum(v[1] for k, v in by_name.items()
                    if any(n in k for n in kernel_key.split("|")))
    copy_us = sum(v[1] for k, v in by_name.items() if "Memcpy" in k or "Memset" in k)
    htod_us = sum(v[1] for k, v in by_name.items() if "Memcpy HtoD" in k)
    out.update({
        "device_ms_per_frame": total_us / 1e3 / n_frames,
        "device_busy_share": busy / max(1.0, window),
        "device_idle_share": 1.0 - busy / max(1.0, window),
        "device_ops_per_frame": len(dev) / n_frames,
        "kernel": kernel_key,
        "kernel_ms_per_frame": kernel_us / 1e3 / n_frames,
        # 1 launch per frame: below 1, CUPTI lost records in this window
        "kernel_events_per_frame": sum(
            v[0] for k, v in by_name.items()
            if any(n in k for n in kernel_key.split("|"))) / n_frames,
        "kernel_share_of_device_time": kernel_us / max(1.0, total_us),
        "copies_and_memsets_ms_per_frame": copy_us / 1e3 / n_frames,
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


@contextlib.contextmanager
def _async_batch(batch: int):
    """SELKIES_TPU_ASYNC_BATCH set to ``batch`` for the factory's reads
    inside the block, restored after it."""
    prev = os.environ.get("SELKIES_TPU_ASYNC_BATCH")
    os.environ["SELKIES_TPU_ASYNC_BATCH"] = str(batch)
    try:
        yield
    finally:
        if prev is None:
            del os.environ["SELKIES_TPU_ASYNC_BATCH"]
        else:
            os.environ["SELKIES_TPU_ASYNC_BATCH"] = prev


#: the server phase's name and wire type by profile
SERVER_PHASES = {"jpeg": ("server", 0x03),
                 "x264enc-striped": ("server_h264", 0x04),
                 "x264enc": ("server_fullframe", 0x00)}


def phase_server(profile: str = "jpeg", min_frames: int = 30,
                 timeout_s: float = 180.0, batch: int = 1):
    """An in-process client through the port's ws_handler at 1920x1080:
    SETTINGS handshake, >= min_frames frames (0x03 JPEG stripes, 0x04 H.264
    stripes for x264enc-striped, one 0x00 full-frame packet per frame for
    x264enc), each ACKed. ``batch`` > 1 serves with
    SELKIES_TPU_ASYNC_BATCH=batch (phase ``<name>_batch``)."""
    from selkies_tpu_torch.protocol.wire import unpack_binary
    from selkies_tpu_torch.robustness import InProcessClient
    from selkies_tpu_torch.server.data_server import DataStreamingServer
    from selkies_tpu_torch.settings import Settings

    name, wire_type = SERVER_PHASES[profile]
    if batch > 1:
        name += "_batch"

    async def run():
        settings = Settings(argv=[], env={"SELKIES_PORT": "0",
                                          "SELKIES_ENCODER": profile})
        server = DataStreamingServer(settings, device=DEVICE)
        try:
            ws = InProcessClient()
            task = asyncio.create_task(server.ws_handler(ws))
            ws.feed("SETTINGS," + json.dumps({
                "displayId": "primary", "initialClientWidth": W,
                "initialClientHeight": H, "framerate": 60}))
            acked, seen, stripes, nbytes = set(), 0, 0, 0
            t0 = time.monotonic()
            first_frame_s = None
            while len(acked) < min_frames \
                    and time.monotonic() - t0 < timeout_s:
                await asyncio.sleep(0.005)
                for m in ws.sent[seen:]:
                    if isinstance(m, (bytes, bytearray)):
                        f = unpack_binary(bytes(m))
                        if wire_type != 0x03:
                            check(m[0] == wire_type
                                  and f.payload[:4] == b"\x00\x00\x00\x01",
                                  f"bad H.264 message for {profile}: "
                                  f"type {m[0]}")
                        else:
                            check(m[0] == 0x03 and f.payload[:2] == b"\xff\xd8"
                                  and f.payload[-2:] == b"\xff\xd9",
                                  "bad 0x03 stripe")
                        stripes += 1
                        nbytes += len(m)
                        if f.frame_id not in acked:
                            if first_frame_s is None:
                                first_frame_s = time.monotonic() - t0
                            acked.add(f.frame_id)
                            ws.feed(f"CLIENT_FRAME_ACK {f.frame_id}")
                seen = len(ws.sent)
            await asyncio.sleep(0.2)
            st = server.display_clients["primary"]
            sup = st.supervisor.stats()
            result = {
                "phase": name, "profile": profile, "wire_type": wire_type,
                "width": W, "height": H,
                "mode": ws.sent[0] if ws.sent else None,
                "frames_received": len(acked), "stripes_received": stripes,
                "bytes_received": nbytes,
                "acknowledged_frame_id": st.bp.acknowledged_frame_id,
                "send_enabled": st.bp.send_enabled,
                "encoder_stats": (st.encoder.stats() if st.encoder is not None
                                  else None),
                "ladder": st.ladder.state(),
                "supervisor": {k: sup[k] for k in (
                    "state", "restarts_total", "failures_total",
                    "watchdog_restarts_total")},
                "first_frame_s": first_frame_s,
                "frames_per_s_after_first": (
                    (len(acked) - 1)
                    / (time.monotonic() - t0 - first_frame_s - 0.2)
                    if first_frame_s is not None and len(acked) > 1 else None),
            }
            await ws.close()
            await asyncio.wait_for(task, 30.0)
        finally:
            await server.stop()
        return result

    with _async_batch(batch):
        res = asyncio.run(run())
    res["async_batch"] = batch
    check(res["mode"] == "MODE websockets", "handshake")
    check(res["frames_received"] >= min_frames,
          f"server sent {res['frames_received']} frames < {min_frames}")
    check(res["acknowledged_frame_id"] >= min_frames, "ACKs not taken")
    es = res["encoder_stats"] or {}
    check(es.get("encode_errors", 0) == 0
          and es.get("entropy_errors", 0) == 0,
          f"server encoder errors: {es}")
    check(batch == 1 or es.get("batch") == batch,
          f"server encoder not batched: {es}")
    # no fault was armed: a kernel that fails to build or launch must fail
    # here, not turn into a stream from a lower rung
    lad, sup = res["ladder"], res["supervisor"]
    check(lad["rung"] == "device" and lad["failures_total"] == 0
          and not lad["transitions"],
          f"{name}: the display left the device rung: {lad}")
    check(sup["restarts_total"] == 0 and sup["failures_total"] == 0
          and sup["state"] == "running",
          f"{name}: the display's capture loop restarted: {sup}")
    return res


#: server_faults: the ladder's threshold and probe window, the watchdog in
#: frame intervals (0.5 s at 60 fps) and a restart budget the phase cannot
#: exhaust; each stage waits for FAULT_STAGE_FRAMES frames at its new rung
FAULT_ENV = {"SELKIES_LADDER_FAIL_THRESHOLD": "3",
             "SELKIES_LADDER_PROBE_MS": "4000",
             "SELKIES_WATCHDOG_FRAMES": "30",
             "SELKIES_SUPERVISOR_MAX_RESTARTS": "50"}
#: seconds each injected fetch hang lasts: past the 0.5 s watchdog, short of
#: the 30 s wedge deadline, and short enough that a driver thread asleep in
#: one ends well before the phase does
FAULT_HANG_S = 3
FAULT_STAGE_FRAMES = 10
FAULT_TIMEOUT_S = 120.0
LADDER_WALK = ["device->host", "host->jpeg", "jpeg->host", "host->device"]


def phase_server_faults():
    """x264enc-striped at W x H, 60 fps, served through ws_handler with
    every frame ACKed, walked down and back up the degradation ladder by
    injected faults, one stage at a time:

    1. ``encode.raise*3``: device -> host (0x04 stripes; me_mc on the card,
       entropy on the host);
    2. ``encode.raise*3``: host -> jpeg (0x03 stripes; dct8 on the card);
    3. a clean window: the ladder probes up to host, then to device;
    4. ``fetch.hang*2=FAULT_HANG_S``: the loop's fetch site and the driver
       thread's harvest both check the point; the driver takes at most one
       (it sleeps in it), so at least one lands in the capture loop, whose
       watchdog restarts the pipeline: a stall, not a failure.

    Each stage waits for FAULT_STAGE_FRAMES frames at its new rung and
    reports the time from arming (from the start of the window, for the
    probes) to the first. A frame is at the rung of the last
    ``system_health`` message before it; the first frame after every
    ``PIPELINE_RESETTING`` must be an IDR (0x04) or a JPEG. Kernel launches
    count at the rung the display is at when the script reads the counters
    (every 5 ms): a frame a closing encoder finishes after a rung change
    counts at the new rung. Returns the phase's line and, by rung, the
    launches of each kernel."""
    import gc
    import threading

    import torch

    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes
    from selkies_tpu_torch.protocol.wire import unpack_binary
    from selkies_tpu_torch.robustness import InProcessClient
    from selkies_tpu_torch.server.data_server import DataStreamingServer
    from selkies_tpu_torch.settings import Settings

    def reserved_mb():
        if DEVICE != "cuda":
            return 0
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_reserved() >> 20

    threads_before = {t.ident for t in threading.enumerate()}
    mb_before = reserved_mb()
    per_rung = {r: {"frames": 0, "stripes": 0, "wire_types": set(),
                    "pipelines": 0, "me_mc": 0, "dct8_quant_zigzag": 0}
                for r in ("device", "host", "jpeg")}

    async def run():
        server = DataStreamingServer(
            Settings(argv=[], env=dict(FAULT_ENV, SELKIES_PORT="0",
                                       SELKIES_ENCODER="x264enc-striped")),
            device=DEVICE)
        try:
            ws = InProcessClient()
            task = asyncio.create_task(server.ws_handler(ws))
            ws.feed("SETTINGS," + json.dumps({
                "displayId": "primary", "initialClientWidth": W,
                "initialClientHeight": H, "framerate": 60}))
            seen = {"n": 0, "rung": "device", "fresh": False, "id": None,
                    "launches": (me_mc_stripes.launches,
                                 dct8_quant_zigzag.launches),
                    "watchdogs": 0, "watchdog_at": None}
            frames = []                 # (time seen, rung) of each frame

            def pump():
                st = server.display_clients.get("primary")
                now = (me_mc_stripes.launches, dct8_quant_zigzag.launches)
                if st is not None:
                    r = per_rung[st.ladder.rung]
                    r["me_mc"] += now[0] - seen["launches"][0]
                    r["dct8_quant_zigzag"] += now[1] - seen["launches"][1]
                    if (st.supervisor is not None and
                            st.supervisor.watchdog_restarts_total
                            > seen["watchdogs"]):
                        seen["watchdogs"] = \
                            st.supervisor.watchdog_restarts_total
                        seen["watchdog_at"] = time.monotonic()
                seen["launches"] = now
                t = time.monotonic()
                for m in ws.sent[seen["n"]:]:
                    if isinstance(m, str):
                        if m.startswith("PIPELINE_RESETTING"):
                            seen["fresh"], seen["id"] = True, None
                        elif '"system_health"' in m:
                            d = json.loads(m)["displays"].get("primary")
                            if d is not None:
                                seen["rung"] = d["rung"]
                        continue
                    m = bytes(m)
                    f = unpack_binary(m)
                    r = per_rung[seen["rung"]]
                    r["stripes"] += 1
                    r["wire_types"].add(m[0])
                    if m[0] == 0x04:
                        check(f.payload[:4] == b"\x00\x00\x00\x01",
                              "server_faults: bad 0x04 stripe")
                    else:
                        check(m[0] == 0x03 and f.payload[:2] == b"\xff\xd8",
                              f"server_faults: bad message of type {m[0]}")
                    if f.frame_id == seen["id"]:
                        continue            # another stripe of the same frame
                    if seen["fresh"]:
                        check(m[0] == 0x03 or m[1] == 1,
                              f"server_faults: first frame of a pipeline at "
                              f"rung {seen['rung']} is not an IDR")
                        seen["fresh"] = False
                        r["pipelines"] += 1
                    seen["id"] = f.frame_id
                    r["frames"] += 1
                    frames.append((t, seen["rung"]))
                    ws.feed(f"CLIENT_FRAME_ACK {f.frame_id}")
                seen["n"] = len(ws.sent)

            async def wait_for(pred, what):
                t0 = time.monotonic()
                while not pred():
                    check(time.monotonic() - t0 < FAULT_TIMEOUT_S,
                          f"server_faults: timed out waiting for {what}")
                    await asyncio.sleep(0.005)
                    pump()

            def frames_at(rung, since):
                return [t for t, r in frames if r == rung and t >= since]

            await wait_for(lambda: len(frames_at("device", 0.0))
                           >= FAULT_STAGE_FRAMES, "frames at rung device")
            st = server.display_clients["primary"]
            sup = st.supervisor
            stages = []
            for name, spec, want in (
                    ("encode.raise:device->host", "encode.raise*3",
                     ["device->host"]),
                    ("encode.raise:host->jpeg", "encode.raise*3",
                     ["host->jpeg"]),
                    ("probe:jpeg->host", None, ["jpeg->host"]),
                    ("probe:host->device", None, ["host->device"])):
                n0 = len(st.ladder.transitions)
                rung = want[0].split("->")[1]
                t_arm = time.monotonic()
                if spec is not None:
                    server.faults.arm_spec(spec)
                await wait_for(
                    lambda: st.ladder.transitions[n0:n0 + 1] == want
                    and len(frames_at(rung, t_arm)) >= FAULT_STAGE_FRAMES,
                    f"{name}: {FAULT_STAGE_FRAMES} frames at rung {rung}")
                stages.append({"stage": name, "armed": spec, "rung": rung,
                               "first_frame_s": frames_at(rung, t_arm)[0] - t_arm,
                               "failures_total": sup.failures_total,
                               "ladder_failures_total": st.ladder.failures_total})
            # 4. the watchdog: a stalled fetch
            failures0, ladder0 = sup.failures_total, st.ladder.failures_total
            watchdogs0 = sup.watchdog_restarts_total
            t_arm = time.monotonic()
            server.faults.arm_spec(f"fetch.hang*2={FAULT_HANG_S}")
            await wait_for(
                lambda: seen["watchdogs"] > watchdogs0
                and server.faults.fired.get("fetch.hang", 0) == 2
                and len(frames_at("device", max(seen["watchdog_at"], t_arm)))
                >= FAULT_STAGE_FRAMES,
                "frames after the watchdog restart")
            stages.append({
                "stage": "fetch.hang:watchdog",
                "armed": f"fetch.hang*2={FAULT_HANG_S}", "rung": "device",
                "first_frame_s": frames_at("device", seen["watchdog_at"])[0]
                - t_arm,
                "watchdog_restarts": sup.watchdog_restarts_total - watchdogs0,
                "failures_added": sup.failures_total - failures0,
                "ladder_failures_added": st.ladder.failures_total - ladder0})
            out = {"phase": "server_faults", "profile": "x264enc-striped",
                   "width": W, "height": H, "fps": 60,
                   "settings": FAULT_ENV, "hang_s": FAULT_HANG_S,
                   "transitions": list(st.ladder.transitions),
                   "rung": st.ladder.rung, "ladder": st.ladder.state(),
                   "supervisor": sup.stats(),
                   "faults_fired": dict(server.faults.fired),
                   "stages": stages,
                   "health": json.loads(server._health_payload())["displays"][
                       "primary"]}
            await ws.close()
            await asyncio.wait_for(task, 30.0)
        finally:
            await server.stop()
        pump()
        return out

    out = asyncio.run(run())
    out["per_rung"] = {r: dict(v, wire_types=sorted(v["wire_types"]))
                       for r, v in per_rung.items()}
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before and t.is_alive()
            and t.name.startswith("torchenc")]
    out["threads_left"] = left
    mb_after = reserved_mb()
    out["reserved_mb"] = {"before": mb_before, "after": mb_after,
                          "growth": mb_after - mb_before}
    hang = out["stages"][-1]
    check(out["transitions"] == LADDER_WALK and out["rung"] == "device",
          f"server_faults: ladder walked {out['transitions']}")
    check(hang["watchdog_restarts"] >= 1 and hang["failures_added"] == 0
          and hang["ladder_failures_added"] == 0,
          f"server_faults: the fetch hang gave {hang}")
    check(out["supervisor"]["failures_total"] == 6
          and out["supervisor"]["state"] != "failed",
          f"server_faults: supervisor {out['supervisor']}")
    pr = out["per_rung"]
    check(pr["device"]["wire_types"] == [0x04]
          and pr["host"]["wire_types"] == [0x04]
          and pr["jpeg"]["wire_types"] == [0x03],
          f"server_faults: wire types by rung {pr}")
    check(pr["device"]["me_mc"] > 0 and pr["host"]["me_mc"] > 0
          and pr["jpeg"]["dct8_quant_zigzag"] > 0,
          f"server_faults: kernel launches by rung {pr}")
    check(not left, f"server_faults: threads still running: {left}")
    check(out["reserved_mb"]["growth"] <= CHURN_GROWTH_MB,
          f"server_faults: reserved memory grew {out['reserved_mb']}")
    return out, per_rung


# ---------------------------------------------------------------------------
# H.264 (x264enc-striped)


def _h264_planes(cur_np, ref_np, enc):
    """The (cur, ref, ref_cb, ref_cr) stripe tensors the P step hands the
    motion kernel for one frame pair (the encoder's own planes on the
    card; the reference here is the previous source frame). Lists of N
    frames give a lane's tick: the sessions' stripes one after another on
    the stripe axis, [N*S, h, w]."""
    import torch

    from selkies_tpu_torch.encoder.h264_device import prepare_planes

    if isinstance(cur_np, list):
        per = [_h264_planes(c, r, enc) for c, r in zip(cur_np, ref_np)]
        return [torch.cat(ts) for ts in zip(*per)]
    S, sh, pw = enc.n_stripes, enc.stripe_h, enc.pad_w
    y1, _, _ = prepare_planes(torch.from_numpy(cur_np).to(enc.device),
                              enc.pad_h, pw)
    y0, cb0, cr0 = prepare_planes(torch.from_numpy(ref_np).to(enc.device),
                                  enc.pad_h, pw)
    return [y1.reshape(S, sh, pw), y0.reshape(S, sh, pw),
            cb0.reshape(S, sh // 2, pw // 2), cr0.reshape(S, sh // 2, pw // 2)]


def _tie_pairs(w: int = W, h: int = H):
    """Frame pairs whose searches tie: "flat" (two constant frames of
    different levels: all 625 offsets have one SAD) and "lattice" (a 4x4
    dot lattice moved by one pixel each way: every offset congruent to
    (1, 1) mod 4 has SAD 0 away from the stripe edges, so the winner is
    the lowest rank among many non-zero offsets)."""
    flat_cur = np.full((h, w, 3), 90, np.uint8)
    flat_ref = np.full((h, w, 3), 100, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    dots = np.where((yy % 4 == 0) & (xx % 4 == 0), 220, 30).astype(np.uint8)
    lat_ref = np.repeat(dots[..., None], 3, -1)
    lat_cur = np.roll(lat_ref, (1, 1), axis=(0, 1))
    return {"flat": (flat_cur, flat_ref), "lattice": (lat_cur, lat_ref)}


def _me_at_shape(enc, int_ops_per_s: float, sessions: int = 0) -> dict:
    """me_mc_stripes against its plain version (full_search_mc) at the
    shapes ``enc``'s P step hands it, on a scroll pair (true motion), a
    noise pair and two pairs whose searches tie (_tie_pairs): mv and the
    three predictions must be exactly equal. Then kernel and plain times
    and the bound of the work. ``sessions=N``: a lane's tick, N sessions'
    pairs (scroll and noise of their own seeds) on one stripe axis. The
    frames are of ``enc``'s geometry."""
    import torch

    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes
    from selkies_tpu_torch.ops.motion import full_search_mc

    w, h = enc.width, enc.height
    geom = "1080p" if (w, h) == (W, H) else f"{w}x{h}"

    def pair_set(k):
        scroll = SyntheticSource(w, h, pattern="scroll", seed=k)
        a = scroll.next_frame()
        return {"scroll": (scroll.next_frame(), a),
                "noise": (SyntheticSource(w, h, pattern="noise", seed=k + 1)
                          .next_frame(),
                          SyntheticSource(w, h, pattern="noise", seed=k + 2)
                          .next_frame()),
                **_tie_pairs(w, h)}

    pairs = pair_set(0)
    if sessions:
        sets = [pair_set(10 * k) for k in range(sessions)]
        pairs = {name: ([s[name][0] for s in sets], [s[name][1] for s in sets])
                 for name in pairs}
    n_diff = n_vals = 0
    per_pair, moved = {}, {}
    for name, (cur, ref) in pairs.items():
        args = _h264_planes(cur, ref, enc)
        got = me_mc_stripes(*args)
        want = full_search_mc(*args)
        torch.cuda.synchronize()
        d = sum(int((g != w_).sum().item()) for g, w_ in zip(got, want))
        per_pair[name] = d
        n_diff += d
        n_vals += sum(g.numel() for g in got)
        moved[name] = int((got[0] != 0).any(-1).sum().item())
    S, h, w = _h264_planes(*pairs["scroll"], enc)[0].shape
    shape = f"[{S},{h},{w}]"
    tiles = -(-w // 128)
    reps, plain_reps = (50, 2) if not sessions else (20, 1)
    check(n_diff == 0, f"me_mc kernel vs plain at {shape}: {n_diff} of "
          f"{n_vals} differ ({per_pair})")
    check(moved["scroll"] > 0, f"{shape}: scroll pair found no motion")
    check(moved["flat"] == 0, f"{shape}: flat pair: a tie went past rank 0")
    check(moved["lattice"] > 0, f"{shape}: lattice pair found no motion")

    args = _h264_planes(*pairs["scroll"], enc)
    kernel_ms, kernel_how = device_ms(lambda: me_mc_stripes(*args), reps,
                                      f"me_mc_stripes{shape}")
    plain_ms, plain_how = device_ms(lambda: full_search_mc(*args),
                                    plain_reps, f"me_mc_stripes{shape}/plain")
    events_ms = cuda_time_ms(lambda: me_mc_stripes(*args), 20)

    n_off = (2 * enc.search + 1) ** 2
    # the fewest instructions the search needs per 4 pixel-offsets: one
    # VABSDIFF4 when ptxas gives it the accumulate (the kernel's SASS holds
    # no IDP.4A to sum the four differences), else VABSDIFF4 + IDP.4A; the
    # per-MB minimum and the predictions add under 1%
    per4 = _sad_instructions_per_4()
    ops = per4 * n_off * S * h * w // 4
    in_bytes = sum(t.numel() for t in args)
    out_bytes = S * h * w + 2 * (S * h * w // 4) + 4 * 2 * (S * h * w // 256)
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    ops_ms = ops / int_ops_per_s * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {
        "shape": shape,
        "max_abs_err": 0 if n_diff == 0 else None,
        "n_diff": n_diff,
        "n_values": n_vals,
        "n_diff_by_pair": per_pair,
        "moved_blocks_by_pair": moved,
        "ms": kernel_ms,
        "ms_timing": f"{kernel_how} device time, {reps} reps, {geom} "
                     "scroll pair" + (f" of each of {sessions} sessions"
                                      if sessions else ""),
        "tiles_128": tiles,
        "last_tile_mbs": (w - 128 * (tiles - 1)) // 16,
        "plain_timing": plain_how,
        "events_ms": events_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "share_of_bound": bound_ms / kernel_ms,
        "bound_basis": (f"{ops:.4g} byte-SIMD instructions ({per4} per 4 "
                        f"pixel-offsets, from the kernel's SASS) / ({INT32_LANES} "
                        f"lanes x {int_ops_per_s / INT32_LANES / 1e6:.0f} "
                        f"MHz max SM clock); {in_bytes + out_bytes} bytes / "
                        "3.35 TB/s"),
        "unit": (f"one lane tick of {sessions} {geom} P frames: "
                 if sessions else f"one {geom} P frame: ")
        + f"{S} stripe(s) of {h}x{w}, 1 launch",
    }


def phase_me_kernel_check(int_ops_per_s: float):
    """me_mc_stripes against its plain version at both shapes the H.264
    profiles give it: 17 stripes of 64x1920 (x264enc-striped), and one
    full-frame stripe of 1088x1920 (x264enc, whose rows 1080-1087 are
    replicate padding inside the stripe). The kernel's entry carries the
    striped numbers; ``full_frame`` those of the full-frame shape, which
    is also the WebRTC mode's one stripe at 1080p; ``webrtc_shapes`` the
    WebRTC entry point's default 1280x720 stripe, [1,720,1280]."""
    from selkies_tpu_torch import _build
    from selkies_tpu_torch.encoder.h264 import H264StripeEncoder

    striped = _me_at_shape(
        H264StripeEncoder(W, H, stripe_height=STRIPE, device=DEVICE),
        int_ops_per_s)
    full = _me_at_shape(H264StripeEncoder(W, H, fullframe=True, device=DEVICE),
                        int_ops_per_s)
    # the resized shapes before the lanes': once CUPTI starts losing a
    # window's records (the N = 8 lane's, in some calls) it tends to keep
    # losing them, and the timings fall back to CUDA events
    resize = {}
    for w, h in RESIZE_GEOMS:
        resize[f"{w}x{h}"] = _me_at_shape(
            H264StripeEncoder(w, h, stripe_height=STRIPE, device=DEVICE),
            int_ops_per_s)
        resize[f"{w}x{h}/full_frame"] = _me_at_shape(
            H264StripeEncoder(w, h, fullframe=True, device=DEVICE),
            int_ops_per_s)
    # the WebRTC mode's one stripe over the frame: at 1080p it is the
    # full-frame shape above; the entry point's default 1280x720 is its own
    webrtc = {"1280x720": _me_at_shape(
        H264StripeEncoder(1280, 720, stripe_height=720, device=DEVICE),
        int_ops_per_s)}
    lanes = {f"N{n}": _me_at_shape(
        H264StripeEncoder(W, H, stripe_height=STRIPE, device=DEVICE),
        int_ops_per_s, sessions=n) for n in MESH_SIZES}
    # multi_device's per-shard launches (see phase_kernel_check)
    shards = {
        "session:2 lane of 8, per device": "lane_shapes N4",
        f"sfe {MD_SFE_W}x{MD_SFE_H} {MD_SFE_MESH}, per shard": _me_at_shape(
            H264StripeEncoder(MD_SFE_W, MD_SFE_BAND,
                              stripe_height=STRIPE, device=DEVICE),
            int_ops_per_s)}
    entry = {
        "name": "me_mc_stripes",
        "route": "cuda",
        "source": "selkies_tpu_torch/csrc/me_mc.cu",
        "replaces": "selkies_tpu/ops/pallas_me.py:234",
        "launches": None,                   # filled from the main-path run
        **striped,
        "library_ms": None,
        "ptxas": [ln.strip() for ln in _build.ptxas_report.get("me_mc", "")
                  .splitlines() if "registers" in ln or "spill" in ln],
        "sass_per_vabsdiff4": _per_vabsdiff4(),
        "full_frame": full,
        "lane_shapes": lanes,
        "resize_shapes": resize,
        "webrtc_shapes": webrtc,
        "shard_shapes": shards,
    }
    return entry


def _me_sass() -> dict:
    kernels = SASS.get("me_mc", {})
    check(len(kernels) == 1, f"me_mc.cu: one kernel expected, SASS has "
          f"{list(kernels)}")
    return next(iter(kernels.values()))


def _vabsdiff4(ops: dict, accumulate=None) -> int:
    return sum(v for k, v in ops.items() if k.startswith("VABSDIFF4")
               and (accumulate is None or (".ACC" in k) == accumulate))


def _sad_instructions_per_4() -> int:
    """1 when every VABSDIFF4 of the kernel's SASS accumulates (.ACC: the
    four differences and their sum in one instruction), else 2 (a
    VABSDIFF4 and an IDP.4A to sum it)."""
    ops = _me_sass()
    n = _vabsdiff4(ops)
    check(n > 0, "me_mc SASS has no VABSDIFF4")
    return 1 if _vabsdiff4(ops, accumulate=True) == n else 2


def _per_vabsdiff4() -> dict:
    """The kernel's ten most frequent SASS opcodes, per VABSDIFF4 (its
    search loop is unrolled, so this is near its inner loop's mix)."""
    ops = _me_sass()
    n = _vabsdiff4(ops)
    return {k: round(v / n, 4) for k, v in list(ops.items())[:10]}


def _served(profile: str, entropy=None, batch: int = 1):
    """The served encoder of ``profile`` at 1080p, as the data server
    builds it (``entropy="host"``: the host rung; ``batch``: its
    SELKIES_TPU_ASYNC_BATCH): (base encoder, pipeline or None behind a
    threaded adapter, what the capture loop drives)."""
    from selkies_tpu_torch.server.data_server import default_encoder_factory
    from selkies_tpu_torch.settings import Settings

    settings = Settings(argv=[], env={"SELKIES_PORT": "0",
                                      "SELKIES_ENCODER": profile})
    ov = {"tpu_entropy": entropy} if entropy else None
    with _async_batch(batch):
        enc = default_encoder_factory(W, H, settings, ov, device=DEVICE)
    pipe = getattr(enc, "pipe", None)
    return (enc.base if pipe is None else pipe.base), pipe, enc


def _h264_pipeline():
    """The served x264enc-striped encoder."""
    return _served("x264enc-striped")


def _fullframe_pipeline():
    """The served full-frame x264enc encoder."""
    return _served("x264enc")


def _h264_recording(base, n_keep: int):
    """Wrap base.harvest: count IDR and P frames, and keep (``n_keep`` >
    0), for every CHECK_EVERY-th P frame, a copy of its exact levels
    on the card (in a buffer allocated here, before any timed window), its
    stripes' QPs and frame numbers, and the stripes it emitted."""
    import torch

    with base.stream_context():
        levels = torch.empty((n_keep, base.n_stripes, base._stripe_words),
                             dtype=torch.int16, device=base.device)
    orig = base.harvest
    kept, counts = [], {"idr": 0, "p": 0}

    def wrapped(p, host=None):
        frame_nums = [st.frame_num for st in base.stripes]
        out = orig(p, host)
        if p.is_idr:
            counts["idr"] += 1
        else:
            counts["p"] += 1
            if n_keep and counts["p"] % CHECK_EVERY == 0:
                slot = len(kept)
                check(slot < n_keep, f"more than {n_keep} P frames kept")
                with base.stream_context():
                    levels[slot].copy_(p.flat16)
                kept.append((levels[slot], p.qp.copy(), frame_nums, out))
        return out

    base.harvest = wrapped
    return kept, counts


def _check_h264(base, kept) -> dict:
    """Every kept stripe's Annex-B must equal the native coder on that
    stripe's exact levels (flat16) fetched from the card."""
    from selkies_tpu_torch.encoder.h264 import encode_picture_nals_np

    mb_w, mb_h = base.pad_w // 16, base.stripe_h // 16
    index = {st.y0: i for i, st in enumerate(base.stripes)}
    tally = {"frames": len(kept), "stripes": 0, "mismatch": 0}
    t0 = time.perf_counter()
    for flat16, qps, frame_nums, out in kept:
        rows = base._to_host(flat16)
        for s in out:
            i = index[s.y_start]
            row = rows[i].astype(np.int32)
            parts, pos = [], 0
            for shape, size in base._shapes:
                parts.append(row[pos:pos + size].reshape(shape))
                pos += size
            want = encode_picture_nals_np(
                *parts, is_idr=False, mb_w=mb_w, mb_h=mb_h,
                qp=int(qps[i]), frame_num=frame_nums[i])
            tally["stripes"] += 1
            tally["mismatch"] += int(s.annexb != want or s.is_key)
    tally["check_s"] = time.perf_counter() - t0
    return tally


def phase_h264_encoder(profile: str = "x264enc-striped"):
    """1920x1080 x264enc-striped (or, for ``profile="x264enc"``, one
    full-frame stripe) through PipelinedH264Encoder + AsyncEncodeDriver
    over the desktop and scroll patterns, N_H264 timed frames each, twice:
    a run that keeps nothing gives the rates; in a checked run every
    CHECK_EVERY-th P frame's levels are kept and its stripes checked after
    the window."""
    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes

    fullframe = profile == "x264enc"
    make = _fullframe_pipeline if fullframe else _h264_pipeline
    out = {"phase": "h264_fullframe_encoder" if fullframe else "h264_encoder",
           "profile": profile, "width": W, "height": H, "patterns": {}}
    p_frames = 0
    for pattern in ("desktop", "scroll"):
        src = SyntheticSource(W, H, pattern=pattern, seed=2)
        frames = [src.next_frame() for _ in range(N_H264 + 2)]
        launches0 = me_mc_stripes.launches
        # warm-up: the IDR, then the first P step
        base, _, (_, counts), results, wall, st = _timed_run(
            make, frames, 2, record=lambda b: _h264_recording(b, 0))
        check(base.n_stripes == (1 if fullframe else -(-H // STRIPE)),
              f"{profile}: {base.n_stripes} stripes")
        launches = me_mc_stripes.launches - launches0
        p_frames += counts["p"]
        check(len(results) == N_H264 and st["encode_errors"] == 0
              and st["entropy_errors"] == 0,
              f"{profile} {pattern}: {len(results)} of {N_H264} frames, {st}")
        base, _, (kept, counts), results_c, wall_c, st_c = _timed_run(
            make, frames, 2,
            record=lambda b: _h264_recording(b, N_H264 // CHECK_EVERY + 1))
        p_frames += counts["p"]
        check(len(results_c) == N_H264 and st_c["encode_errors"] == 0
              and st_c["entropy_errors"] == 0,
              f"{profile} {pattern} checked: {len(results_c)} of {N_H264} "
              f"frames, {st_c}")
        tally = _check_h264(base, kept)
        check(tally["mismatch"] == 0 and tally["stripes"] > 0,
              f"{profile} {pattern}: stripes vs native coder {tally}")
        out["patterns"][pattern] = {
            "frames": N_H264,
            **_rates(N_H264, wall, st),
            "stripes_per_frame": sum(len(s) for _, s in results) / N_H264,
            "bytes_per_frame": sum(len(x.annexb) for _, s in results
                                   for x in s) / N_H264,
            "wire_bytes_per_frame": _wire_bytes(results, fullframe) / N_H264,
            "d2h_bytes_per_frame": st["d2h_bytes_per_frame"],
            "host_entropy_ms_per_frame": st["host_entropy_ms_per_frame"],
            "host_coded_stripes": st["host_coded_stripes"],
            "entropy_errors_total": st["entropy_errors"] + st_c["entropy_errors"],
            "inflight_batches_max": st["inflight_batches_max"],
            "me_mc_launches": launches,
            "checked_run": _rates(N_H264, wall_c, st_c),
            "checked_frames": tally["frames"],
            "checked_stripes": tally["stripes"],
            "check_s": tally["check_s"],
        }
    out["p_frames_dispatched"] = p_frames
    return out


def check_fullframe_large_payload() -> dict:
    """x264enc at QP 18 on a 1080p noise P frame (after a desktop IDR),
    with each entropy tier. Device tier: the payload passes the large
    fetch prefix, so harvest re-reads the buffer (and the exact levels
    where the stripe passed its byte budget). Host tier: the stripe's
    nonzero cells pass the cap (and wrap the head's u16 count), so harvest
    re-reads its exact levels. Either way the Annex-B must equal the
    native coder on the exact levels, fetched from the card."""
    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.encoder import h264_device as dev
    from selkies_tpu_torch.encoder.h264 import (H264StripeEncoder,
                                                encode_picture_nals_np)

    desk = SyntheticSource(W, H, pattern="desktop", seed=12).next_frame()
    noise = SyntheticSource(W, H, pattern="noise", seed=13).next_frame()
    out = {}
    for entropy in ("device", "host"):
        enc = H264StripeEncoder(W, H, fullframe=True, qp=18, entropy=entropy,
                                device=DEVICE)
        enc.encode_frame(desk)
        frame_num = enc.stripes[0].frame_num
        p = enc.dispatch(noise)
        row = enc._to_host(p.flat16)[0].astype(np.int32)
        head = enc._to_host(p.head[:4])
        (got,) = enc.harvest(p)
        parts, pos = [], 0
        for shape, size in enc._shapes:
            parts.append(row[pos:pos + size].reshape(shape))
            pos += size
        want = encode_picture_nals_np(
            *parts, is_idr=False, mb_w=enc.pad_w // 16,
            mb_h=enc.stripe_h // 16, qp=18, frame_num=frame_num)
        check(got.annexb == want and not got.is_key,
              f"x264enc/{entropy} noise P frame differs from the native coder")
        res = {"annexb_bytes": len(got.annexb),
               "prefix_large": enc._prefix_large,
               "d2h_refetch_bytes": enc.d2h_refetch_bytes_total,
               "host_coded_stripes": enc.host_coded_stripes_total}
        if entropy == "device":
            check(len(got.annexb) > enc._prefix_large
                  and enc.d2h_refetch_bytes_total > 0,
                  f"x264enc/device noise frame did not pass the prefix: {res}")
        else:
            pad = np.zeros(enc._pad_words, np.int32)
            pad[:row.size] = row
            cells = int(pad.reshape(-1, dev.CELL).any(-1).sum())
            count = int(head[0]) | (int(head[1]) << 8)
            res.update(nonzero_cells=cells, cap_cells=enc._cap_cells,
                       head_count=count, head_overflow=int(head[3]))
            check(cells > enc._cap_cells and head[3] == 1
                  and count == cells % 65536
                  and enc.host_coded_stripes_total == 1,
                  f"x264enc/host noise frame: {res}")
        out[entropy] = res
    return out


def phase_host_rung(profile: str):
    """The host-entropy rung of ``profile`` ("x264enc-striped" or "jpeg")
    at 1920x1080, behind ThreadedEncoderAdapter as the data server builds
    it, over the desktop and scroll patterns: N_HOST timed frames each,
    after the warm-up frames (H.264: the IDR and the first P frame). Returns
    the phase's numbers and, per pattern, the frames and the adapter's
    results, which :func:`check_host_rung` holds against the device rung
    once the caller has read the launch counts."""
    from selkies_tpu_torch.capture.synthetic import SyntheticSource

    h264 = profile != "jpeg"
    n_warm = 2 if h264 else 1
    out = {"phase": "host_rung", "profile": profile, "entropy": "host",
           "width": W, "height": H, "patterns": {}, "frames_dispatched": 0,
           "p_frames_dispatched": 0}
    runs = {}
    for pattern in ("desktop", "scroll"):
        src = SyntheticSource(W, H, pattern=pattern, seed=2)
        frames = [src.next_frame() for _ in range(N_HOST + n_warm)]
        record = (lambda b: _h264_recording(b, 0)) if h264 else None
        base, pipe, kept, results, wall, st = _timed_run(
            lambda: _served(profile, "host"), frames, n_warm, record=record)
        check(pipe is None and base.entropy == "host",
              f"{profile}: the factory's host rung is not the threaded one")
        check(len(results) == N_HOST and st["encode_errors"] == 0
              and st["entropy_errors"] == 0,
              f"{profile} host {pattern}: {len(results)} of {N_HOST} "
              f"frames, {st}")
        out["frames_dispatched"] += len(frames)
        if h264:
            out["p_frames_dispatched"] += kept[1]["p"]
        out["patterns"][pattern] = {
            "frames": N_HOST,
            **_rates(N_HOST, wall, st),
            "stripes_per_frame": sum(len(x) for _, x in results) / N_HOST,
            "wire_bytes_per_frame": _wire_bytes(results) / N_HOST,
            "d2h_bytes_per_frame": st["d2h_bytes_per_frame"],
            "host_entropy_ms_per_frame": st["host_entropy_ms_per_frame"],
            "host_coded_stripes": st["host_coded_stripes"],
            "entropy_errors": st["entropy_errors"],
        }
        runs[pattern] = (frames, results)
    return out, runs


def check_host_rung(profile: str, out: dict, runs: dict) -> None:
    """Every timed frame of the host rung against the device rung of the
    same profile (the factory's encoder, driven synchronously on the card
    so its paint-over timing is the adapter's): the same stripes, byte for
    byte."""
    h264 = profile != "jpeg"

    def key(x):
        return (x.y_start, x.is_key, x.annexb) if h264 else \
            (x.y_start, x.is_paintover, x.jpeg)

    for pattern, (frames, results) in runs.items():
        base, _, drv = _served(profile)
        drv.close()
        drv.join(30.0)
        check(base.entropy == "device", f"{profile}: no device rung")
        device = [[key(x) for x in base.encode_frame(f)] for f in frames]
        same = sum(device[seq] == [key(x) for x in stripes]
                   for seq, stripes in results)
        check(same == len(results),
              f"{profile} {pattern}: host rung equals the device rung on "
              f"{same} of {len(results)} frames")
        out["patterns"][pattern]["frames_identical_to_device_rung"] = same


# ---------------------------------------------------------------------------
# batched H.264 dispatch and frames made on the card

#: frames per batched dispatch (bench.py's BATCH), batches per timed run,
#: and the batches of the host-tier run
BATCH = 12
N_BATCHES = 8
N_HOST_BATCHES = 3
#: batches (at BATCH) or frames/BATCH (at 1) in each profiled window
PROFILE_BATCHES = 2


def _batch_pipeline(profile: str, batch: int, entropy: str = "device"):
    """The pipeline the factory builds for ``profile`` with
    SELKIES_TPU_ASYNC_BATCH=``batch`` (depth max(4, 3B), fetch groups of
    2), driven directly as bench.py drives it (``submit_batch``)."""
    from selkies_tpu_torch.encoder.h264 import H264StripeEncoder
    from selkies_tpu_torch.encoder.pipeline import PipelinedH264Encoder

    geo = dict(fullframe=True) if profile == "x264enc" else \
        dict(stripe_height=STRIPE)
    base = H264StripeEncoder(W, H, entropy=entropy, device=DEVICE, **geo)
    return PipelinedH264Encoder(base, depth=max(4, 3 * batch), fetch_group=2,
                                batch=batch)


def _annexb(stripes):
    return [(s.y_start, s.is_key, s.annexb) for s in stripes]


def _batch_run(profile: str, batch: int, n_batches: int,
               entropy: str = "device", profiled: bool = False):
    """1080p DeviceScrollSource frames (seed 2) through the pipeline at
    ``batch``: two frames one by one (the IDR and the first P frame), one
    warm batch of BATCH frames, then ``n_batches`` timed batches of BATCH
    frames (at batch 1 the same frames one by one), every batch
    harvested as it completes. Returns (every frame's stripes in order,
    the timed window's numbers); ``profiled`` puts the timed window under
    torch.profiler and adds the device's share of it. The device memory
    the run allocated at its peak, over what was allocated before it, is
    ``peak_allocated_mb``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from selkies_tpu_torch.capture.synthetic import DeviceScrollSource

    alloc0 = _peak_mark()
    pipe = _batch_pipeline(profile, batch, entropy)
    try:
        src = DeviceScrollSource(W, H, seed=2, device=DEVICE)
        results = {}

        def feed(n):
            if batch == 1:
                for _ in range(n):
                    pipe.submit(src.next_frame())
                    results.update(pipe.poll(flush_partial=False))
            else:
                for _ in range(n // batch):
                    pipe.submit_batch(src.next_batch(batch))
                    results.update(pipe.poll(flush_partial=False))

        for _ in range(2):
            pipe.submit(src.next_frame())
        results.update(pipe.flush())
        feed(BATCH)
        results.update(pipe.flush())
        pipe._dispatch_ms.clear()
        d2h0 = pipe.d2h_bytes_total + pipe.base.d2h_refetch_bytes_total
        ems0 = pipe.base.host_entropy_ms_total
        n = n_batches * BATCH
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) \
            if profiled else None
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        for _ in range(n_batches):
            feed(BATCH)
        results.update(pipe.flush())
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        st = pipe.stats()
        check(len(results) == 2 + BATCH + n and st["entropy_errors"] == 0,
              f"{profile}/{entropy} batch {batch}: {len(results)} frames, "
              f"{st}")
        out = {"batch": batch, "frames": n, "fps": n / wall,
               "dispatch_p50_ms": st["dispatch_p50_ms"],
               "dispatch_p50_ms_per_frame": st["dispatch_p50_ms"] / batch,
               "d2h_bytes_per_frame":
                   (pipe.d2h_bytes_total + pipe.base.d2h_refetch_bytes_total
                    - d2h0) / n,
               "host_entropy_ms_per_frame":
                   (pipe.base.host_entropy_ms_total - ems0) / n,
               "host_coded_stripes": st["host_coded_stripes"],
               "staging_stalls": st["staging_stalls"]}
        if prof is not None:
            out.update(_device_share(prof, n, wall))
    finally:
        pipe.close()
    out.update(_peak_since(alloc0))
    return [_annexb(results[k]) for k in range(len(results))], out


def _release_cache() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def _peak_mark() -> int:
    """Start a memory-peak window: resets the allocator's peak and returns
    the bytes allocated now (0 off the card)."""
    import torch

    if DEVICE != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_since(alloc0: int) -> dict:
    """The window's peak of allocated device memory over its start, and
    the allocator's reserved memory now, in MB."""
    import torch

    if DEVICE != "cuda":
        return {}
    return {"peak_allocated_mb":
                (torch.cuda.max_memory_allocated() - alloc0) / 2**20,
            "reserved_mb": torch.cuda.memory_reserved() / 2**20}


def _device_share(prof, n_frames: int, wall_s: float) -> dict:
    """Device ops, device time and busy share per frame from a profile."""
    import torch

    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(dev), "profiler recorded no device events")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    return {"device_ops_per_frame": len(dev) / n_frames,
            # 1 launch per P frame: below 1, CUPTI lost records here
            "me_mc_events_per_frame": sum(
                "me_mc_kernel" in e.name for e in dev) / n_frames,
            "device_ms_per_frame": sum(e.time_range.elapsed_us()
                                       for e in dev) / 1e3 / n_frames,
            "device_busy_share": busy / 1e6 / wall_s,
            "wall_ms_per_frame": wall_s * 1e3 / n_frames}


def _counted_run(profile: str, batch: int, n_batches: int, **kw):
    """``_batch_run`` with the me_mc count set to 0 just before it and
    read just after; the count must be the run's P frames (all but the
    first frame). Returns (stripes, numbers with ``me_mc_launches``)."""
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes

    me_mc_stripes.launches = 0
    stripes, res = _batch_run(profile, batch, n_batches, **kw)
    res["me_mc_launches"] = me_mc_stripes.launches
    check(res["me_mc_launches"] == len(stripes) - 1,
          f"{profile} batch {batch}: {res['me_mc_launches']} me_mc "
          f"launches for {len(stripes) - 1} P frames")
    return stripes, res


def phase_h264_batch():
    """Batched dispatch at 1080p with frames made on the card, for both
    H.264 profiles: one frame per dispatch, then CHURN_BATCH (the served
    batch) and BATCH frames per ``submit_batch``, over the same frames
    (every frame's stripes must equal the one-frame run's), each timed
    and with its memory peak; then B = 1 and B = BATCH profiled (device
    ops per frame), and B = BATCH profiled once more with the whole batch
    in one packer call (``h264_device.PACK_FRAMES`` = BATCH), which weighs
    the chunked pack's ops against its memory. Last, a short host-tier
    run at BATCH (its D2H bytes per frame), whose stripes must equal the
    device tier's one-frame run. Every run's me_mc launches are counted
    from 0 on their own. Returns the phase and, per path, the launches of
    its timed run."""
    from selkies_tpu_torch.encoder import h264_device

    out = {"phase": "h264_batch", "width": W, "height": H, "batch": BATCH,
           "pack_frames": h264_device.PACK_FRAMES,
           "source": "DeviceScrollSource, frames made on the card",
           "profiles": {}}
    launches = {}
    solo_striped = None
    for profile in ("x264enc-striped", "x264enc"):
        res = {}
        solo, res["batch_1"] = _counted_run(profile, 1, N_BATCHES)
        launches[f"{profile}/batch1"] = res["batch_1"]["me_mc_launches"]
        for b in (CHURN_BATCH, BATCH):
            batched, res[f"batch_{b}"] = _counted_run(profile, b, N_BATCHES)
            same = sum(x == y for x, y in zip(solo, batched))
            check(len(solo) == len(batched) and same == len(solo),
                  f"{profile}: batch {b} equals batch 1 on {same} of "
                  f"{len(solo)} frames")
            check(sum(len(x) for x in batched) > 0, f"{profile}: no stripes")
            res[f"batch_{b}"]["frames_identical_to_batch_1"] = same
            launches[f"{profile}/batch{b}"] = \
                res[f"batch_{b}"]["me_mc_launches"]
        _, res["profile_batch_1"] = _counted_run(profile, 1, PROFILE_BATCHES,
                                                 profiled=True)
        _, res[f"profile_batch_{BATCH}"] = _counted_run(
            profile, BATCH, PROFILE_BATCHES, profiled=True)
        chunk = h264_device.PACK_FRAMES
        h264_device.PACK_FRAMES = BATCH
        try:
            _, res[f"profile_batch_{BATCH}_one_pack"] = _counted_run(
                profile, BATCH, PROFILE_BATCHES, profiled=True)
        finally:
            h264_device.PACK_FRAMES = chunk
        # the one-call pack's peak is no path's: hand its cached blocks
        # back, so later phases read the served paths' reserve
        _release_cache()
        res["device_ops_ratio_1_to_batch"] = (
            res["profile_batch_1"]["device_ops_per_frame"]
            / res[f"profile_batch_{BATCH}"]["device_ops_per_frame"])
        out["profiles"][profile] = res
        if profile == "x264enc-striped":
            solo_striped = solo
    host, res = _counted_run("x264enc-striped", BATCH, N_HOST_BATCHES,
                             entropy="host")
    same = sum(a == b for a, b in zip(host, solo_striped))
    check(same == len(host),
          f"host tier batch {BATCH}: {same} of {len(host)} frames equal the "
          "device tier's")
    res["frames_identical_to_device_batch_1"] = same
    launches[f"x264enc-striped/host/batch{BATCH}"] = res["me_mc_launches"]
    out["host_tier"] = res
    return out, launches


def phase_jpeg_device_frames():
    """The JPEG pipeline behind its async driver at 1080p, fed N_FRAMES
    scroll frames made on the card (DeviceScrollSource at the padded
    1088 rows, handed over as tensors: no staging) and, in turn, the same
    frames as host arrays (staged and uploaded): host, device, device,
    host. Every run's stripes must be equal. Returns the phase and the
    dct8 launches of its device-frame runs."""
    from selkies_tpu_torch.capture.synthetic import DeviceScrollSource
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag

    pad_h = -(-H // STRIPE) * STRIPE        # the encoder's padded height
    src = DeviceScrollSource(W, pad_h, seed=2, device=DEVICE)
    dev_frames = [src.next_frame() for _ in range(N_FRAMES + 1)]
    host_frames = [f.cpu().numpy() for f in dev_frames]
    runs, launches = [], 0
    for kind in ("host", "device", "device", "host"):
        frames = dev_frames if kind == "device" else host_frames
        l0 = dct8_quant_zigzag.launches
        _, pipe, _, results, wall, st = _timed_run(_pipeline, frames, 1)
        if kind == "device":
            launches += dct8_quant_zigzag.launches - l0
            check(pipe._staging.staged_total == 0,
                  "device frames went through the staging ring")
        check(len(results) == N_FRAMES and st["encode_errors"] == 0,
              f"jpeg {kind} frames: {len(results)} of {N_FRAMES}, {st}")
        runs.append((kind, results, _rates(N_FRAMES, wall, st), st))
    want = [[(x.y_start, x.jpeg) for x in s] for _, s in runs[0][1]]
    for kind, results, _, _ in runs[1:]:
        got = [[(x.y_start, x.jpeg) for x in s] for _, s in results]
        check(got == want, f"jpeg {kind} frames: stripes differ")
    out = {"phase": "jpeg_device_frames", "width": W, "height": pad_h,
           "frames": N_FRAMES, "order": [r[0] for r in runs],
           "runs": [dict(kind=k, **rates,
                         d2h_bytes_per_frame=st["d2h_bytes_per_frame"])
                    for k, _, rates, st in runs],
           "kernel_launches_device_runs": launches}
    for kind in ("host", "device"):
        fps = [r[2]["fps"] for r in runs if r[0] == kind]
        out[f"{kind}_frames_fps_mean"] = sum(fps) / len(fps)
    out["device_over_host_fps"] = (out["device_frames_fps_mean"]
                                   / out["host_frames_fps_mean"])
    return out, launches


#: mesh_encoder: each lane's (profile, entropy tier, sessions); its first
#: ticks checked against solo encoders (every session against one of its
#: own), the ticks of its timed run and of its profiled window; the
#: scheduler's in-flight window; the frames of each solo figure's runs
MESH_CONFIGS = (("jpeg", None, 4), ("jpeg", None, 8),
                ("x264enc-striped", "device", 4),
                ("x264enc-striped", "device", 8),
                ("x264enc-striped", "host", 4))
MESH_CHECK_TICKS = 6
MESH_TICKS = 30
MESH_PROFILE_TICKS = 3
MESH_WINDOW = 2
MESH_SOLO_FRAMES = 40
MESH_SOLO_PROFILE_FRAMES = 6


def _lane_encoder(profile: str, entropy, n: int):
    """A lane of ``n`` slots of ``profile`` at W x H on the card, with the
    settings' defaults (the scheduler's default factory builds the same)."""
    import torch

    from selkies_tpu_torch.parallel.mesh import (MeshStripeEncoder,
                                                 parse_mesh_spec)
    from selkies_tpu_torch.parallel.mesh_h264 import MeshH264Encoder

    mesh = parse_mesh_spec("session:1", [torch.device(DEVICE)])
    if profile == "jpeg":
        return MeshStripeEncoder(mesh, n, W, H, stripe_h=STRIPE)
    return MeshH264Encoder(mesh, n, W, H, stripe_h=STRIPE, entropy=entropy)


def _solo_encoder(profile: str, entropy):
    from selkies_tpu_torch.encoder.h264 import H264StripeEncoder
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder

    if profile == "jpeg":
        return JpegStripeEncoder(W, H, stripe_height=STRIPE, device=DEVICE)
    return H264StripeEncoder(W, H, stripe_height=STRIPE, entropy=entropy,
                             device=DEVICE)


class _LaneFeed:
    """Each session's frames made on the card: a DeviceScrollSource of its
    own (seed k, k frames in, at the padded 1088 rows). The last session
    has a frame on the first tick only, and is idle (None) after it."""

    def __init__(self, n: int) -> None:
        from selkies_tpu_torch.capture.synthetic import DeviceScrollSource

        pad_h = -(-H // STRIPE) * STRIPE
        self.src = []
        for k in range(n):
            src = DeviceScrollSource(W, pad_h, seed=k, device=DEVICE)
            for _ in range(k):
                src.next_frame()
            self.src.append(src)
        self.ticks = 0

    def next(self):
        out = [src.next_frame() for src in self.src]
        if self.ticks:
            out[-1] = None
        self.ticks += 1
        return out


def _stripe_bytes(stripes):
    return [(s.y_start, getattr(s, "is_key", None),
             getattr(s, "annexb", None) or s.jpeg) for s in stripes]


def _lane_drive(lane, feeds, window: int = MESH_WINDOW):
    """Drive ``lane`` over the tick frames ``feeds`` yields as the scheduler
    does: up to ``window`` dispatched ticks in flight, the oldest harvested
    first when the window is full, any whose copy landed harvested after
    each dispatch. Returns (outputs per tick, wall s, dispatch ms each)."""
    import torch

    from collections import deque

    inflight, out, disp = deque(), [], []

    def harvest():
        out.append(lane.harvest(inflight.popleft())[0])

    t0 = time.perf_counter()
    for frames in feeds:
        while len(inflight) >= window:
            harvest()
        td = time.perf_counter()
        inflight.append(lane.dispatch(frames))
        disp.append((time.perf_counter() - td) * 1e3)
        while inflight and lane.fetch_ready(inflight[0]):
            harvest()
    while inflight:
        harvest()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, disp


def _lane_check_against_solo(profile: str, entropy, n: int, got) -> dict:
    """``got``: a lane's outputs over its first MESH_CHECK_TICKS ticks of
    _LaneFeed frames, driven as the timed run drives it (MESH_WINDOW
    ticks in flight). Each session's frames go through a solo encoder of
    its own: every session's stripes on every tick must equal its solo
    encoder's (the idle session's: nothing)."""
    feed = _LaneFeed(n)
    solos = [_solo_encoder(profile, entropy) for _ in range(n)]
    stripes = frames = mismatch = 0
    t0 = time.perf_counter()
    for t in range(MESH_CHECK_TICKS):
        for k, f in enumerate(feed.next()):
            want = [] if f is None else _stripe_bytes(solos[k].encode_frame(f))
            frames += f is not None
            stripes += len(want)
            mismatch += _stripe_bytes(got[t][k]) != want
    check(mismatch == 0, f"lane {profile}/{entropy} of {n}: {mismatch} "
          f"session-frames differ from their solo encoders'")
    check(stripes > 0, "lane check: no stripes")
    return {"ticks": MESH_CHECK_TICKS, "session_frames": frames,
            "stripes": stripes, "mismatch": mismatch,
            "check_s": time.perf_counter() - t0}


def _lane_run(profile: str, entropy, n: int):
    """A lane warmed by two ticks (the join, a first P tick), MESH_TICKS
    timed ticks and MESH_PROFILE_TICKS profiled ticks (frames made before
    the profiler starts), every run at the scheduler's window, with the
    kernel launches counted from 0 just before the lane runs and read just
    after (one per tick), and the lane's memory peak over what was
    allocated before it was built; last, the first MESH_CHECK_TICKS ticks
    of the warm and timed runs against solo encoders. Returns (numbers,
    launches)."""
    from selkies_tpu_torch.encoder.device_entropy import huffman_pack
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes

    kernel = dct8_quant_zigzag if profile == "jpeg" else me_mc_stripes
    other = me_mc_stripes if profile == "jpeg" else dct8_quant_zigzag
    alloc0 = _peak_mark()
    kernel.launches = other.launches = huffman_pack.launches = 0
    lane = _lane_encoder(profile, entropy, n)
    feed = _LaneFeed(n)
    warm, _, _ = _lane_drive(lane, [feed.next() for _ in range(2)])
    d2h0, l0 = lane.d2h_bytes_total, kernel.launches
    out, wall, disp = _lane_drive(lane, (feed.next()
                                         for _ in range(MESH_TICKS)))
    timed_launches = kernel.launches - l0
    d2h = lane.d2h_bytes_total - d2h0
    peak = _peak_since(alloc0)
    frames = [feed.next() for _ in range(MESH_PROFILE_TICKS)]
    prof = _profiler()
    with prof:
        _, pwall, _ = _lane_drive(lane, frames)
    share = _device_share(prof, MESH_PROFILE_TICKS, pwall)
    launches = kernel.launches
    ticks = 2 + MESH_TICKS + MESH_PROFILE_TICKS
    check(launches == ticks and timed_launches == MESH_TICKS
          and other.launches == 0,
          f"lane {profile}/{entropy} of {n}: {launches} launches in "
          f"{ticks} ticks ({timed_launches} in {MESH_TICKS} timed), "
          f"{other.launches} of the other kernel")
    # the JPEG lane packs all its sessions in one call a tick
    pack_launches = huffman_pack.launches
    check(DEVICE != "cuda"
          or pack_launches == (2 * ticks if profile == "jpeg" else 0),
          f"lane {profile}/{entropy} of {n}: {pack_launches} huffman_pack "
          f"launches in {ticks} ticks")
    active = n - 1
    stripes = sum(len(s) for tick in out for s in tick)
    wire = sum(len(b) for tick in out for s in tick
               for _, _, b in _stripe_bytes(s))
    res = {"profile": profile, "entropy": entropy or "device",
           "sessions": n, "active_sessions": active, "ticks": MESH_TICKS,
           "aggregate_fps": active * MESH_TICKS / wall,
           "fps_per_session": MESH_TICKS / wall,
           "tick_ms": wall * 1e3 / MESH_TICKS,
           "tick_dispatch_p50_ms": float(np.median(disp)),
           "d2h_bytes_per_tick": d2h / MESH_TICKS,
           "h2d_bytes_total": lane.h2d_bytes_total,
           "stripes_per_tick": stripes / MESH_TICKS,
           "wire_payload_bytes_per_tick": wire / MESH_TICKS,
           "kernel": "dct8_quant_zigzag" if profile == "jpeg"
           else "me_mc_stripes",
           "kernel_launches": launches,
           "huffman_pack_launches": pack_launches,
           "lane_ticks": ticks,
           "kernel_launches_per_tick": timed_launches / MESH_TICKS,
           "device_ops_per_tick": share["device_ops_per_frame"],
           "device_ops_per_session_frame":
               share["device_ops_per_frame"] / active,
           "device_ms_per_tick": share["device_ms_per_frame"],
           "device_busy_share": share["device_busy_share"],
           "me_mc_events_per_tick": share["me_mc_events_per_frame"],
           "profiled_tick_ms": share["wall_ms_per_frame"]}
    res.update({f"lane_{k}": v for k, v in peak.items()})
    del lane
    res["checked"] = _lane_check_against_solo(
        profile, entropy, n, (warm + out)[:MESH_CHECK_TICKS])
    return res, launches


def _solo_figures(profile: str, entropy) -> dict:
    """The solo served encoder of the same profile and tier in the same
    call (pipelined behind its driver, or the host rung's threaded
    adapter), on MESH_SOLO_FRAMES frames made on the card: fps, dispatch
    (encode) p50, D2H bytes per frame; and a short profiled run's device
    ops per frame and busy share."""
    from selkies_tpu_torch.capture.synthetic import DeviceScrollSource

    pad_h = -(-H // STRIPE) * STRIPE

    def make():
        if profile == "jpeg":
            return _pipeline()
        return _served(profile, entropy)

    def frames(n):
        src = DeviceScrollSource(W, pad_h, seed=0, device=DEVICE)
        return [src.next_frame() for _ in range(n + 1)]

    _, _, _, res, wall, st = _timed_run(make, frames(MESH_SOLO_FRAMES), 1)
    check(len(res) == MESH_SOLO_FRAMES and st.get("encode_errors", 0) == 0,
          f"solo {profile}/{entropy}: {len(res)} frames, {st}")
    out = _rates(MESH_SOLO_FRAMES, wall, st)
    out["d2h_bytes_per_frame"] = st.get("d2h_bytes_per_frame")
    _, _, _, _, _, pst = _timed_run(make, frames(MESH_SOLO_PROFILE_FRAMES), 1,
                                    profiled=True)
    out.update({"device_ops_per_frame": pst["device_ops_per_frame"],
                "device_busy_share": pst["device_busy_share"],
                "profiled_fps": 1e3 / pst["wall_ms_per_frame"]})
    return out


def phase_mesh_encoder():
    """Multi-session lanes at 1080p on the card (MESH_CONFIGS): each
    lane's checked run (every session's bytes equal its own solo
    encoder's), its timed run (aggregate and per-session fps, tick
    dispatch p50, D2H bytes per tick, one kernel launch per tick, the
    lane's memory peak) and its profiled window (device ops per tick and
    per session-frame, busy share), beside the solo served encoder's
    figures of the same profile in the same call. Returns the phase and
    the kernels' launches by path (``mesh:<profile>/N<sessions>``, each
    lane's own run)."""
    out = {"phase": "mesh_encoder", "width": W, "height": H,
           "stripe_h": STRIPE, "window": MESH_WINDOW,
           "source": "DeviceScrollSource per session (own seed and "
                     "offset), the last session idle after its first tick",
           "lanes": [], "solo": {}}
    launches = {}
    for profile, entropy, n in MESH_CONFIGS:
        _settle(f"mesh_encoder/{profile}/{entropy}/{n}")
        res, count = _lane_run(profile, entropy, n)
        out["lanes"].append(res)
        path = ("mesh:" + profile + ("/host" if entropy == "host" else "")
                + f"/N{n}")
        launches[path] = count
        key = f"{profile}/{entropy or 'device'}"
        if key not in out["solo"]:
            out["solo"][key] = _solo_figures(profile, entropy)
    return out, launches


#: server_mesh: displays in the lane, frames each must have ACKed, and
#: the scheduler settings of tests/test_swarm.py's admission server (one
#: lane of 4 slots; the fifth display queues for ADMISSION_QUEUE_MS, then
#: is shed)
SERVER_MESH_DISPLAYS = 4
SERVER_MESH_FRAMES = 30
SERVER_MESH_ENV = {"SELKIES_PORT": "0", "SELKIES_ENCODER": "x264enc-striped",
                   "SELKIES_TPU_MESH": "session:1",
                   "SELKIES_TPU_SESSIONS_PER_CHIP": "4",
                   "SELKIES_MESH_MAX_LANES": "1",
                   "SELKIES_SECOND_SCREEN": "true",
                   "SELKIES_MAX_DISPLAYS": "0",
                   "SELKIES_ADMISSION_QUEUE_MS": "500",
                   "SELKIES_WATCHDOG_FRAMES": "0",
                   "SELKIES_SUPERVISOR_MAX_RESTARTS": "1000"}
SERVER_MESH_TIMEOUT_S = 180.0


class _Viewer:
    """One in-process client of a display: reads what the server sent,
    ACKs every new frame id, and keeps the frame-id epochs apart (each
    ``PIPELINE_RESETTING`` restarts the ids at 1)."""

    def __init__(self, server, display_id: str) -> None:
        from selkies_tpu_torch.robustness import InProcessClient

        self.did = display_id
        self.ws = InProcessClient()
        self.task = asyncio.create_task(server.ws_handler(self.ws))
        self.seen = 0
        self.epoch = 0
        self.frames = []            # (epoch, frame id, monotonic time)
        self.resets = []            # monotonic time of each reset
        self.health = []
        self.t_open = time.monotonic()
        self.ws.feed("SETTINGS," + json.dumps({
            "displayId": display_id, "initialClientWidth": W,
            "initialClientHeight": H, "framerate": 60}))

    def pump(self) -> None:
        from selkies_tpu_torch.protocol.wire import unpack_binary

        now = time.monotonic()
        for m in self.ws.sent[self.seen:]:
            if isinstance(m, (bytes, bytearray)):
                f = unpack_binary(bytes(m))
                check(m[0] == 0x04 and f.payload[:4] == b"\x00\x00\x00\x01",
                      f"{self.did}: bad message type {m[0]}")
                key = (self.epoch, f.frame_id)
                if not self.frames or self.frames[-1][:2] != key:
                    self.frames.append((self.epoch, f.frame_id, now))
                    self.ws.feed(f"CLIENT_FRAME_ACK {f.frame_id}")
            elif m == f"PIPELINE_RESETTING {self.did}":
                self.epoch += 1
                self.resets.append(now)
            elif '"system_health"' in m:
                self.health.append(json.loads(m))
        self.seen = len(self.ws.sent)

    def first_frame_s(self):
        return self.frames[0][2] - self.t_open if self.frames else None

    def fps(self):
        if len(self.frames) < 2:
            return None
        return (len(self.frames) - 1) / (self.frames[-1][2]
                                         - self.frames[0][2])


def phase_server_mesh():
    """Four x264enc-striped 1080p displays at 60 fps served from one lane
    through the port's ws_handler (tpu_mesh session:1, 4 sessions per
    card, one lane), every frame ACKed, each until it has
    SERVER_MESH_FRAMES frames; a fifth display is queued, then shed with
    KILL server_full. Then the bucket's lane cap is raised to 2, so a sick
    slot's session has a lane to move to, and ``mesh.slot_raise`` is armed
    on the first display's slot: the slot is quarantined and the session
    migrates (a second lane is built), its frame ids restart after
    PIPELINE_RESETTING, its restart budget is forgiven, and the other
    three keep streaming. The system_health feed's ``mesh`` key is read;
    after the displays close, the drained lane with the quarantined slot
    retires. Reserved memory before and after; every display rode the
    lane (``solo_fallback`` 0)."""
    import torch

    from selkies_tpu_torch.ops.me_mc import me_mc_stripes
    from selkies_tpu_torch.server.data_server import DataStreamingServer
    from selkies_tpu_torch.settings import Settings

    async def until(pred, viewers, timeout):
        t0 = time.monotonic()
        while not pred() and time.monotonic() - t0 < timeout:
            await asyncio.sleep(0.005)
            for v in viewers:
                v.pump()
        return pred()

    async def run():
        reserved0 = torch.cuda.memory_reserved()
        me_mc_stripes.launches = 0
        server = DataStreamingServer(Settings(argv=[], env=SERVER_MESH_ENV),
                                     device=DEVICE)
        try:
            views = [_Viewer(server, f"d{k}")
                     for k in range(SERVER_MESH_DISPLAYS)]
            ok = await until(lambda: all(len(v.frames) >= SERVER_MESH_FRAMES
                                         for v in views), views,
                             SERVER_MESH_TIMEOUT_S)
            check(ok, "lane displays: " + str([len(v.frames) for v in views]))
            served = {v.did: {"first_frame_s": v.first_frame_s(),
                              "frames_per_s": v.fps(), "frames": len(v.frames)}
                      for v in views}
            coord = server.mesh_coordinators[(W, H, "x264enc-striped")]
            st0 = coord.stats()
            check(st0["lanes"] == 1 and st0["active_sessions"] == 4,
                  f"one lane of 4 expected: {st0}")

            fifth = _Viewer(server, "d4")
            t5 = time.monotonic()
            shed = await until(lambda: fifth.ws.closed, views + [fifth], 30.0)
            fifth.pump()
            check(shed and "KILL server_full" in fifth.ws.texts(),
                  "the fifth display was not shed")
            shed_s = time.monotonic() - t5
            edge = dict(server.edge_stats)
            check(edge["sessions_queued"] >= 1
                  and edge["sessions_rejected"] >= 1,
                  f"admission counters: {edge}")
            await asyncio.wait_for(fifth.task, 10.0)

            victim = server.display_clients["d0"]
            facade = victim.encoder
            lane0, slot0 = facade.lane_id, facade.slot
            before = [len(v.frames) for v in views]
            coord.max_lanes = 2
            t_arm = time.monotonic()
            server.faults.arm("mesh.slot_raise", times=4,
                              arg=f"{lane0}:{slot0}")
            ok = await until(lambda: coord.migrations_total >= 1, views, 60.0)
            check(ok, f"no migration: {coord.stats()}")
            t_mig = time.monotonic()
            ok = await until(
                lambda: any(e >= 2 and t > t_mig - 1.0 for e, _, t
                            in views[0].frames[before[0]:]), views, 60.0)
            check(ok, "the migrated display sent no frame after its reset")
            first_after = next((fid, t) for e, fid, t
                               in views[0].frames[before[0]:] if e >= 2)
            await until(lambda: False, views, 1.0)
            after = [len(v.frames) for v in views]
            check(all(a > b + 5 for a, b in zip(after[1:], before[1:])),
                  f"cohabitants stalled: {before} -> {after}")
            health = json.loads(server._health_payload())
            mesh = health.get("mesh", {}).get(f"{W}x{H}/x264enc-striped", {})
            check(mesh.get("migrations_total") == 1
                  and mesh.get("quarantined_slots") == 1
                  and mesh.get("lanes") == 2
                  and mesh.get("active_sessions") == 4,
                  f"system_health mesh entry: {mesh}")
            broadcast = any("mesh" in h for v in views for h in v.health)
            sup = victim.supervisor.stats()
            result = {
                "phase": "server_mesh", "profile": "x264enc-striped",
                "width": W, "height": H, "env": SERVER_MESH_ENV,
                "displays": served,
                "fifth_display": {"shed": True, "shed_after_s": shed_s,
                                  **edge},
                "migration": {
                    "arming_to_migration_s": t_mig - t_arm,
                    "arming_to_first_frame_s": first_after[1] - t_arm,
                    "first_frame_id_after": first_after[0],
                    "epochs_of_victim": views[0].epoch,
                    "victim_lane_slot_before": [lane0, slot0],
                    "victim_lane_slot_after": [facade.lane_id, facade.slot],
                    "victim_supervisor": {k: sup[k] for k in (
                        "state", "restarts_total", "failures_total")},
                    "victim_failure_times_left":
                        len(victim.supervisor._failure_times),
                    "cohabitant_frames_during": [
                        a - b for a, b in zip(after[1:], before[1:])],
                    "slot_faults_total": coord.slot_faults_total},
                "health_mesh": {k: mesh[k] for k in (
                    "active_sessions", "lanes", "capacity_slots", "free_slots",
                    "quarantined_slots", "migrations_total",
                    "tick_errors_total")},
                "health_broadcast_with_mesh": broadcast,
                "mesh_stats": dict(server.mesh_stats),
            }
            check(views[0].epoch >= 2 and first_after[0] == 1,
                  f"the victim's frame ids did not restart: {result}")
            check(facade.lane_id != lane0 and sup["restarts_total"] == 0
                  and sup["state"] == "running"
                  and not victim.supervisor._failure_times,
                  f"migration recovery: {result['migration']}")
            for v in views:
                await v.ws.close()
                await asyncio.wait_for(v.task, 30.0)
            ok = await until(lambda: coord.lanes_retired_total >= 1, [],
                             coord.lane_retire_s + 10.0)
            result["lanes_retired_total"] = coord.lanes_retired_total
            result["slot_accounting"] = coord.verify_slot_accounting()
            check(ok and result["slot_accounting"] == [],
                  f"lanes after the displays left: {coord.stats()}")
        finally:
            await server.stop()
        result["me_mc_launches"] = me_mc_stripes.launches
        result["reserved_mb_before"] = reserved0 / 2**20
        result["reserved_mb_after"] = torch.cuda.memory_reserved() / 2**20
        return result

    res = asyncio.run(run())
    check(res["mesh_stats"] == {"bucketed": SERVER_MESH_DISPLAYS,
                                "solo_fallback": 0},
          f"displays did not ride the lane: {res['mesh_stats']}")
    growth = res["reserved_mb_after"] - res["reserved_mb_before"]
    res["reserved_growth_mb"] = growth
    check(growth <= CHURN_GROWTH_MB,
          f"server_mesh: reserved memory grew {growth:.0f} MB")
    check(res["me_mc_launches"] > 0, "the lane never launched me_mc")
    return res


#: multi_device: the sessions of a lane over the session axis (two shards
#: of MD_LANE_SESSIONS / 2), the ticks each lane runs, and the split-frame
#: display (MD_SFE_W x MD_SFE_H over "session:1,stripe:2") served until
#: MD_SFE_FRAMES frames are ACKed
MD_LANE_SESSIONS = 8
MD_LANE_TICKS = 6
MD_SFE_W, MD_SFE_H = 3840, 2160
MD_SFE_MESH = "session:1,stripe:2"
#: the padded rows of one SFE shard's band: the frame's rows padded to
#: whole bands of two stripe shards, halved (1088 at 2160)
MD_SFE_BAND = -(-MD_SFE_H // (2 * STRIPE)) * STRIPE
MD_SFE_FRAMES = 24
MD_SFE_TIMEOUT_S = 60.0


def _md_devices():
    """The two devices the mesh's shards go on: cuda:0 and cuda:1 where
    the call has two cards or more, else cuda:0 twice (named explicitly:
    a mesh spec is never folded onto fewer devices)."""
    import torch

    if DEVICE != "cuda":                 # a CPU rehearsal
        return [DEVICE, DEVICE], 0
    cards = torch.cuda.device_count()
    return (["cuda:0", "cuda:1"] if cards >= 2 else ["cuda:0", "cuda:0"]), \
        cards


def _sync(devs) -> None:
    import torch

    if DEVICE == "cuda":
        for d in sorted(set(devs)):
            torch.cuda.synchronize(d)


def _zero_counts():
    from selkies_tpu_torch.encoder.device_entropy import huffman_pack
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes

    for k in (dct8_quant_zigzag, me_mc_stripes, huffman_pack):
        k.launches = 0
        k.launches_by_device.clear()


def _md_lane(profile: str, devs) -> dict:
    """A lane of MD_LANE_SESSIONS 1080p sessions over ``session:2`` (half
    the sessions on each device) against the same lane on one device, on
    the same frames made on cuda:0 (DeviceScrollSource, the last session
    idle after its first tick), both at the scheduler's window: every
    session-frame's bytes equal. Launches counted from 0 just before the
    two-device lane runs, read just after, by device."""
    import torch

    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes
    from selkies_tpu_torch.parallel.mesh import (MeshStripeEncoder,
                                                 parse_mesh_spec)
    from selkies_tpu_torch.parallel.mesh_h264 import MeshH264Encoder

    def lane(spec, devices):
        mesh = parse_mesh_spec(spec, [torch.device(d) for d in devices])
        if profile == "jpeg":
            return MeshStripeEncoder(mesh, MD_LANE_SESSIONS, W, H,
                                     stripe_h=STRIPE)
        return MeshH264Encoder(mesh, MD_LANE_SESSIONS, W, H,
                               stripe_h=STRIPE)

    from selkies_tpu_torch.encoder.device_entropy import huffman_pack

    kernel = dct8_quant_zigzag if profile == "jpeg" else me_mc_stripes
    feed = _LaneFeed(MD_LANE_SESSIONS)
    ticks = [feed.next() for _ in range(MD_LANE_TICKS)]
    one = lane("session:1", devs[:1])
    want, one_wall, one_disp = _lane_drive(one, ticks)
    del one
    two = lane("session:2", devs)
    _zero_counts()
    got, wall, disp = _lane_drive(two, ticks)
    _sync(devs)
    by_dev = dict(kernel.launches_by_device)
    pack_by_dev = dict(huffman_pack.launches_by_device)
    per_shard = two.last_harvest_stages["per_shard_fetch_ms"]
    del two
    frames = mismatch = stripes = 0
    for t in range(MD_LANE_TICKS):
        for k in range(MD_LANE_SESSIONS):
            w_, g_ = _stripe_bytes(want[t][k]), _stripe_bytes(got[t][k])
            frames += 1
            stripes += len(g_)
            mismatch += w_ != g_
    check(mismatch == 0, f"multi_device lane {profile}: {mismatch} of "
          f"{frames} session-frames differ from the one-device lane's")
    check(stripes > 0, f"multi_device lane {profile}: no stripes")
    for d in set(devs) - {"cpu"}:
        check(by_dev.get(d, 0) > 0,
              f"multi_device lane {profile}: no {kernel.__name__} launch "
              f"on {d} ({by_dev})")
    check(DEVICE != "cuda" or sum(by_dev.values()) == 2 * MD_LANE_TICKS,
          f"multi_device lane {profile}: {by_dev} launches for "
          f"{MD_LANE_TICKS} ticks of 2 shards")
    # the JPEG lane packs each shard in one call: two launches
    check(DEVICE != "cuda" or sum(pack_by_dev.values())
          == (4 * MD_LANE_TICKS if profile == "jpeg" else 0),
          f"multi_device lane {profile}: {pack_by_dev} huffman_pack "
          f"launches for {MD_LANE_TICKS} ticks of 2 shards")
    return {"profile": profile, "mesh": "session:2", "devices": devs,
            "sessions": MD_LANE_SESSIONS,
            "sessions_per_shard": MD_LANE_SESSIONS // 2,
            "ticks": MD_LANE_TICKS,
            "session_frames_equal_one_device": frames - mismatch,
            "mismatch": mismatch, "stripes": stripes,
            "tick_dispatch_p50_ms": float(np.median(disp)),
            "one_device_tick_dispatch_p50_ms": float(np.median(one_disp)),
            "tick_ms": wall * 1e3 / MD_LANE_TICKS,
            "one_device_tick_ms": one_wall * 1e3 / MD_LANE_TICKS,
            "per_shard_fetch_ms": per_shard,
            "kernel": kernel.__name__, "kernel_launches": kernel.launches,
            "kernel_launches_by_device": by_dev,
            "huffman_pack_launches_by_device": pack_by_dev}


class _SfeRecorder:
    """A lane encoder that records what the scheduler asks of it — each
    dispatch's slot-0 frame, each harvest's slot-0 stripes, keyframe
    requests and slot resets, in order; each dispatch's wall and each
    harvest's per-shard fetch wall — and forwards the rest. A frame is
    kept by reference, not copied on the ticker's thread: the server's
    source makes a new array for every frame and nothing writes to it
    after it is submitted."""

    def __init__(self, enc, log: list, timing: dict) -> None:
        self._enc, self._log, self._timing = enc, log, timing

    def __getattr__(self, name):
        return getattr(self._enc, name)

    def dispatch(self, frames):
        f = frames[0]
        self._log.append(("dispatch", f))
        t0 = time.perf_counter()
        p = self._enc.dispatch(frames)
        self._timing["dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
        return p

    def harvest(self, p):
        out, coded = self._enc.harvest(p)
        self._log.append(("harvest", list(out[0])))
        self._timing["per_shard_fetch_ms"].append(
            self._enc.last_harvest_stages["per_shard_fetch_ms"])
        return out, coded

    def force_keyframe(self, slot):
        self._log.append(("key", slot))
        self._enc.force_keyframe(slot)

    def reset_session(self, slot):
        self._log.append(("reset", slot))
        self._enc.reset_session(slot)


def _sfe_served(profile: str, devs) -> dict:
    """One MD_SFE_W x MD_SFE_H display of ``profile`` served through
    ws_handler from an SFE lane over MD_SFE_MESH on ``devs`` (a stripe
    band per shard), every frame ACKed until MD_SFE_FRAMES are: served
    fps, tick dispatch p50 (the lane's dispatch wall), per-shard fetch
    p50, sfe_fetch and sfe_concat p50 (the scheduler's stats), the health
    feed's sfe_shards and the capacity's chips_per_slot; then the lane's
    recorded calls replayed in order on the same lane over one device
    (cuda:0): every access unit's stripes equal. Launches from 0 just
    before the display opens, read after it closes, by device."""
    import torch

    from selkies_tpu_torch.encoder.device_entropy import huffman_pack
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes
    from selkies_tpu_torch.parallel.coordinator import MeshEncodeCoordinator
    from selkies_tpu_torch.parallel.mesh import Mesh, MeshStripeEncoder
    from selkies_tpu_torch.parallel.mesh_h264 import MeshH264Encoder
    from selkies_tpu_torch.protocol.wire import unpack_binary
    from selkies_tpu_torch.robustness import InProcessClient
    from selkies_tpu_torch.server import data_server
    from selkies_tpu_torch.settings import Settings

    log: list = []
    timing = {"dispatch_ms": [], "per_shard_fetch_ms": []}

    class Recorded(MeshEncodeCoordinator):
        def _build_default_factory(self, *a, **kw):
            make = super()._build_default_factory(*a, **kw)
            return lambda n: _SfeRecorder(make(n), log, timing)

    wire_type = SERVER_PHASES[profile][1]
    kernel = dct8_quant_zigzag if profile == "jpeg" else me_mc_stripes

    settings = Settings(argv=[], env={
        "SELKIES_PORT": "0", "SELKIES_ENCODER": profile,
        "SELKIES_TPU_MESH": MD_SFE_MESH,
        "SELKIES_TPU_SESSIONS_PER_CHIP": "1",
        "SELKIES_MESH_MAX_LANES": "1", "SELKIES_WATCHDOG_FRAMES": "0"})

    async def run():
        server = data_server.DataStreamingServer(settings, device=DEVICE)
        server.coordinator_factory = functools.partial(Recorded, devices=devs)
        interval, data_server.STATS_INTERVAL_S = \
            data_server.STATS_INTERVAL_S, 0.5
        _zero_counts()
        ws = InProcessClient()
        task = asyncio.create_task(server.ws_handler(ws))
        t_open = time.monotonic()
        ws.feed("SETTINGS," + json.dumps({
            "displayId": "primary", "initialClientWidth": MD_SFE_W,
            "initialClientHeight": MD_SFE_H, "framerate": 60}))
        acked, seen, t_first, net = [], 0, None, []
        try:
            while len(acked) < MD_SFE_FRAMES \
                    and time.monotonic() - t_open < MD_SFE_TIMEOUT_S:
                await asyncio.sleep(0.002)
                for msg in ws.sent[seen:]:
                    if isinstance(msg, (bytes, bytearray)):
                        check(msg[0] == wire_type,
                              f"sfe {profile}: type {msg[0]}")
                        f = unpack_binary(bytes(msg))
                        if f.frame_id not in acked:
                            acked.append(f.frame_id)
                            t_first = t_first or time.monotonic()
                            ws.feed(f"CLIENT_FRAME_ACK {f.frame_id}")
                    elif '"network_stats"' in msg:
                        net.append(json.loads(msg))
                seen = len(ws.sent)
            t_last = time.monotonic()
            while not any("mesh_sfe_shards" in n for n in net) \
                    and time.monotonic() - t_open < MD_SFE_TIMEOUT_S + 5:
                await asyncio.sleep(0.05)
                net += [json.loads(m) for m in ws.sent[seen:]
                        if isinstance(m, str) and '"network_stats"' in m]
                seen = len(ws.sent)
            coord = server.mesh_coordinators[(MD_SFE_W, MD_SFE_H, profile)]
            health = json.loads(server._health_payload())["mesh"][
                f"{MD_SFE_W}x{MD_SFE_H}/{profile}"]
            cap, stats = coord.capacity(), coord.stats()
            sup = server.display_clients["primary"].supervisor.stats()
            await ws.close()
            await asyncio.wait_for(task, 30.0)
        finally:
            await server.stop()
            data_server.STATS_INTERVAL_S = interval
        return acked, t_first, t_last, t_open, health, cap, stats, sup, net

    acked, t_first, t_last, t_open, health, cap, stats, sup, net = \
        asyncio.run(run())
    _sync(devs)
    by_dev = dict(kernel.launches_by_device)
    pack_by_dev = dict(huffman_pack.launches_by_device)
    check(len(acked) >= MD_SFE_FRAMES,
          f"sfe {profile}: {len(acked)} frames ACKed")
    check(sup["restarts_total"] == 0 and sup["failures_total"] == 0,
          f"sfe {profile}: the display failed: {sup}")
    check(health["sfe_shards"] == 2 and cap["chips_per_slot"] == 2
          and stats["sfe_shards"] == 2,
          f"sfe {profile}: health {health}, capacity {cap}")
    check(any(n.get("mesh_sfe_shards") == 2 for n in net),
          f"sfe {profile}: the stats feed lacks mesh_sfe_shards 2")
    for d in set(devs) - {"cpu"}:
        check(by_dev.get(d, 0) > 0,
              f"sfe {profile}: no {kernel.__name__} launch on {d} "
              f"({by_dev})")
        check((pack_by_dev.get(d, 0) > 0) == (profile == "jpeg"),
              f"sfe {profile}: huffman_pack launches {pack_by_dev}")

    # every access unit against the same lane on one device (cuda:0), with
    # the settings the scheduler gave it, fed the recorded calls in their
    # order: keyframe requests, resets, dispatches and harvests (the
    # paint-over history advances at harvest, so the in-flight window is
    # part of what is replayed)
    mesh1 = Mesh([[torch.device(devs[0])]])
    kw = {"stripe_h": int(settings.tpu_stripe_height),
          "use_paint_over_quality": bool(
              settings.use_paint_over_quality.value)}
    if profile == "jpeg":
        one = MeshStripeEncoder(
            mesh1, 1, MD_SFE_W, MD_SFE_H,
            quality=int(settings.jpeg_quality.default),
            paintover_quality=int(settings.paint_over_jpeg_quality.default),
            **kw)
    else:
        one = MeshH264Encoder(
            mesh1, 1, MD_SFE_W, MD_SFE_H,
            qp=int(settings.h264_crf.default),
            paint_over_qp=int(settings.h264_paintover_crf.default), **kw)
    pending, n_au, mismatch, stripes = [], 0, 0, 0
    for kind, arg in log:
        if kind == "key":
            one.force_keyframe(0)
        elif kind == "reset":
            one.reset_session(0)
        elif kind == "dispatch":
            pending.append(one.dispatch([arg]))
        else:
            want = _stripe_bytes(one.harvest(pending.pop(0))[0][0])
            got = _stripe_bytes(arg)
            n_au += 1
            stripes += len(got)
            mismatch += want != got
    _sync(devs)
    del one
    check(n_au >= MD_SFE_FRAMES and mismatch == 0,
          f"sfe {profile}: {mismatch} of {n_au} access units differ from "
          "the one-device lane's")
    shard_ms = np.array(timing["per_shard_fetch_ms"], float)
    return {"profile": profile, "geometry": [MD_SFE_W, MD_SFE_H],
            "tpu_mesh": MD_SFE_MESH, "devices": devs,
            "health_sfe_shards": health["sfe_shards"],
            "chips_per_slot": cap["chips_per_slot"],
            "ticks": len(timing["dispatch_ms"]),
            "access_units_checked": n_au, "stripes_checked": stripes,
            "mismatch": mismatch, "frames_acked": len(acked),
            "first_frame_s": t_first - t_open,
            "served_fps": (len(acked) - 1) / (t_last - t_first),
            "tick_dispatch_p50_ms": float(np.median(timing["dispatch_ms"])),
            "per_shard_fetch_ms_p50": [float(x) for x in
                                       np.median(shard_ms, axis=0)],
            "sfe_fetch_ms_p50": stats["sfe_fetch_ms_p50"],
            "sfe_concat_ms_p50": stats["sfe_concat_ms_p50"],
            "kernel": kernel.__name__, "kernel_launches": kernel.launches,
            "kernel_launches_by_device": by_dev,
            "huffman_pack_launches_by_device": pack_by_dev}


def _md_second_card() -> dict:
    """Both kernels launched on cuda:1 while cuda:0 is current, each held
    exactly against its plain version on cuda:1 and against the same
    launch on cuda:0, counted on cuda:1 (needs two cards)."""
    import torch

    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.encoder.h264 import H264StripeEncoder
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder
    from selkies_tpu_torch.ops.dct_quant import (dct8_quant_zigzag,
                                                 dct8_quant_zigzag_plain)
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes
    from selkies_tpu_torch.ops.motion import full_search_mc

    last = torch.device("cuda", 1)
    frame = SyntheticSource(W, H, pattern="noise", seed=20).next_frame()
    planes0 = _lane_planes([frame], JpegStripeEncoder(
        W, H, stripe_height=STRIPE, device="cuda:0"))
    planes1 = [tuple(t.to(last) for t in p) for p in planes0]
    scroll = SyntheticSource(W, H, pattern="scroll", seed=0)
    ref = scroll.next_frame()
    args0 = _h264_planes(scroll.next_frame(), ref, H264StripeEncoder(
        W, H, stripe_height=STRIPE, device="cuda:0"))
    args1 = [t.to(last) for t in args0]
    torch.cuda.synchronize(last)
    _zero_counts()
    with torch.cuda.device(0):
        check(torch.cuda.current_device() == 0, "cuda:0 not current")
        dct1 = dct8_quant_zigzag(planes1)
        me1 = me_mc_stripes(*args1)
    dct0 = dct8_quant_zigzag(planes0)
    me0 = me_mc_stripes(*args0)
    by_dev = {"dct8_quant_zigzag": dict(dct8_quant_zigzag.launches_by_device),
              "me_mc_stripes": dict(me_mc_stripes.launches_by_device)}
    dct_err = max(int((g.int() - dct8_quant_zigzag_plain(*p).int())
                      .abs().max().item()) for g, p in zip(dct1, planes1))
    dct_vs0 = max(int((a.cpu().int() - b.cpu().int()).abs().max().item())
                  for a, b in zip(dct1, dct0))
    want = full_search_mc(*args1)
    me_diff = sum(int((g != w_).sum().item()) for g, w_ in zip(me1, want))
    me_vs0 = sum(int((a.cpu() != b.cpu()).sum().item())
                 for a, b in zip(me1, me0))
    check(dct_err == 0 and dct_vs0 == 0,
          f"dct8 on {last}: max |diff| {dct_err} vs plain, {dct_vs0} vs "
          "cuda:0")
    check(me_diff == 0 and me_vs0 == 0,
          f"me_mc on {last}: {me_diff} values differ from plain, {me_vs0} "
          "from cuda:0")
    for name, d in by_dev.items():
        check(d.get(str(last), 0) == 1 and d.get("cuda:0", 0) == 1,
              f"{name} launches by device {d}")
    return {"card": str(last), "current_device": "cuda:0",
            "dct8_max_abs_err_vs_plain": dct_err,
            "dct8_max_abs_diff_vs_cuda0": dct_vs0,
            "me_mc_values_differing_vs_plain": me_diff,
            "me_mc_values_differing_vs_cuda0": me_vs0,
            "launches_by_device": by_dev}


def phase_multi_device():
    """Lanes and split-frame encoding over a mesh of two shards: on two
    cards where the call has them, else both shards on cuda:0 (the line's
    ``cards`` says which). A ``session:2`` lane of each profile against
    the one-device lane (_md_lane); an SFE display of each profile served
    through ws_handler (_sfe_served); with a second card, both kernels on
    it while cuda:0 is current (_md_second_card). Returns the line and the
    kernels' launches by path and device."""
    t0 = time.perf_counter()
    devs, cards = _md_devices()
    lanes = [_md_lane(p, devs) for p in ("jpeg", "x264enc-striped")]
    sfe = [_sfe_served(p, devs) for p in ("jpeg", "x264enc-striped")]
    second = _md_second_card() if cards >= 2 else {
        "second_card": f"absent ({cards} card in this call)"}
    launches = {}
    for r in lanes:
        launches[f"multi:{r['profile']}/session:2"] = \
            r["kernel_launches_by_device"]
    for r in sfe:
        launches[f"multi:{r['profile']}/sfe:{MD_SFE_MESH} (server)"] = \
            r["kernel_launches_by_device"]
    return {"phase": "multi_device", "gpu": CARD.get("name_power"),
            "cards": cards, "distinct_devices_used": len(set(devs)),
            "shards_on": devs, "lanes": lanes, "sfe": sfe,
            "kernels_on_second_card": second,
            "seconds": time.perf_counter() - t0}, launches


#: server_resize: the walk each served profile takes from 1920x1080, the
#: ACKed frames each of its steps waits for, the storm's resizes (the last
#: one wins), and the time a step may take
RESIZE_WALK = ((1366, 768), (2560, 1440), (1920, 1080))
RESIZE_FRAMES = 30
RESIZE_STORM = 20
RESIZE_TIMEOUT_S = 120.0
#: the lane case: the cohabitants' longest gap between frames in the
#: second after the resize, and the frames each should have there
LANE_RESIZE_MAX_GAP_S = 0.5
LANE_RESIZE_TARGET_FRAMES = 15


def _reserved_mb() -> int:
    """The CUDA allocator's reserved memory in MB, once the card is idle
    (0 in a CPU rehearsal)."""
    import torch

    if DEVICE != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_reserved() >> 20


class _Client:
    """One in-process client of the served primary display: reads what the
    server sent (and drops it, so a long phase keeps no media), ACKs every
    new frame id when ``ack``, keeps the frame-id epochs apart (each
    ``PIPELINE_RESETTING`` restarts the ids at 1) and keeps the wire bytes
    of each epoch's frame 1."""

    def __init__(self, server, settings=None, ws=None, ack=True) -> None:
        from selkies_tpu_torch.robustness import InProcessClient

        self.ws = ws if ws is not None else InProcessClient()
        self.task = asyncio.create_task(server.ws_handler(self.ws))
        self.ack = ack
        self.epoch = 0
        self.frames = []            # (epoch, frame id, monotonic time)
        self.resets = []            # monotonic time of each reset
        self.first = {}             # epoch -> wire messages of frame 1
        self.texts = []
        if settings is not None:
            self.ws.feed("SETTINGS," + json.dumps(settings))

    def pump(self) -> None:
        from selkies_tpu_torch.protocol.wire import unpack_binary

        now = time.monotonic()
        sent, self.ws.sent = self.ws.sent, []
        for m in sent:
            if isinstance(m, (bytes, bytearray)):
                f = unpack_binary(bytes(m))
                if f.frame_id == 1:
                    self.first.setdefault(self.epoch, []).append(bytes(m))
                key = (self.epoch, f.frame_id)
                if not self.frames or self.frames[-1][:2] != key:
                    self.frames.append((self.epoch, f.frame_id, now))
                    if self.ack:
                        self.ws.feed(f"CLIENT_FRAME_ACK {f.frame_id}")
            elif m == "PIPELINE_RESETTING primary":
                self.epoch += 1
                self.resets.append(now)
            else:
                self.texts.append(m)

    def in_epoch(self, epoch: int):
        return [t for e, _, t in self.frames if e == epoch]

    def between(self, t0: float, t1: float) -> int:
        return sum(1 for _, _, t in self.frames if t0 <= t < t1)


def _fps(times) -> float:
    return (len(times) - 1) / (times[-1] - times[0]) if len(times) > 1 \
        else None


async def _until(pred, clients, timeout: float) -> bool:
    t0 = time.monotonic()
    while True:
        for c in clients:
            c.pump()
        if pred():
            return True
        if time.monotonic() - t0 > timeout:
            return False
        await asyncio.sleep(0.005)


def _fresh_first_frame(profile: str, w: int, h: int, settings) -> list:
    """The wire messages of frame 1 of a display of ``w`` x ``h``: the
    served source's first frame encoded synchronously on the card by a
    fresh encoder of that geometry, built by the served factory."""
    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.server.data_server import (_pack_stripe,
                                                      default_encoder_factory)

    frame = SyntheticSource(w, h, 60, pattern="desktop").next_frame()
    drv = default_encoder_factory(w, h, settings, {}, device=DEVICE)
    try:
        stripes = drv.pipe.base.encode_frame(frame)
        return [_pack_stripe(1, s, drv) for s in stripes]
    finally:
        drv.close()
        drv.join(30.0)


def _served_state(server) -> dict:
    st = server.display_clients["primary"]
    sup = st.supervisor.stats()
    return {"ladder": st.ladder.state(),
            "supervisor": {k: sup[k] for k in (
                "state", "restarts_total", "failures_total")},
            "geometry": [st.width, st.height],
            "encoder_stats": st.encoder.stats()}


def _check_served(name: str, state: dict) -> None:
    """No fault was armed: the display stays on its device rung, its
    capture loop never restarted and its encoder counts no error."""
    lad, sup = state["ladder"], state["supervisor"]
    check(lad["rung"] == "device" and lad["failures_total"] == 0
          and not lad["transitions"], f"{name}: left the device rung: {lad}")
    check(sup["restarts_total"] == 0 and sup["failures_total"] == 0
          and sup["state"] == "running", f"{name}: restarted: {sup}")
    es = state["encoder_stats"]
    check(es.get("encode_errors", 0) == 0 and es.get("entropy_errors", 0) == 0,
          f"{name}: encoder errors: {es}")


def phase_server_resize():
    """Each served profile at 1920x1080 through ws_handler (an in-process
    owner ACKing every frame), walked mid-stream through r,1366x768 ->
    r,2560x1440 -> r,1920x1080. Each step's kernel launches are counted
    from 0 just before its ``r`` and read just after its RESIZE_FRAMES
    frames (paths ``resize:<profile>/<W>x<H>``) and must cover every frame
    (JPEG) or P frame (H.264) at the new geometry; its frame 1 must equal
    the same source frame encoded synchronously on the card by a fresh
    encoder of that geometry; the time from ``r`` to that frame and the
    rate over the step's frames are reported. Then the walk again, half
    the frames a step (the reserved memory after it within
    CHURN_GROWTH_MB of the first's), and a storm of RESIZE_STORM resizes
    within 100 ms: at most 2 reconfigurations, at least RESIZE_STORM - 2
    coalesced, the display at the storm's last geometry. Last, four 1080p
    x264enc-striped displays share one lane and one resizes: it streams
    from the new geometry's bucket while the others keep streaming, and
    resized back, the drained bucket retires; then the resize once more
    with each bucket's scheduler on a thread of its own (the JAX
    server's design), for comparison."""
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes
    from selkies_tpu_torch.server.data_server import DataStreamingServer
    from selkies_tpu_torch.settings import Settings

    launches = {}
    out = {"phase": "server_resize", "width": W, "height": H,
           "frames_per_step": RESIZE_FRAMES, "profiles": {}}

    async def walk(server, c, profile, detail: bool):
        frames_needed = RESIZE_FRAMES if detail else RESIZE_FRAMES // 2
        kernel, other = ((dct8_quant_zigzag, me_mc_stripes)
                         if profile == "jpeg"
                         else (me_mc_stripes, dct8_quant_zigzag))
        steps = {}
        for w, h in RESIZE_WALK:
            ep = c.epoch
            dct8_quant_zigzag.launches = me_mc_stripes.launches = 0
            t0 = time.monotonic()
            c.ws.feed(f"r,{w}x{h}")
            ok = await _until(lambda: len(c.in_epoch(ep + 1))
                              >= frames_needed, [c], RESIZE_TIMEOUT_S)
            n_kernel, n_other = kernel.launches, other.launches
            check(ok and c.epoch == ep + 1,
                  f"{profile} {w}x{h}: {len(c.in_epoch(ep + 1))} frames, "
                  f"epoch {c.epoch}")
            times = c.in_epoch(ep + 1)
            frames = len(times)
            need = frames if profile == "jpeg" else frames - 1
            check(n_kernel >= need and n_other == 0,
                  f"{profile} {w}x{h}: {n_kernel} launches for {need} "
                  f"{'frames' if profile == 'jpeg' else 'P frames'}, "
                  f"{n_other} of the other kernel")
            step = {"reset_s": c.resets[-1] - t0,
                    "first_frame_s": times[0] - t0,
                    "frames": frames, "frames_per_s": _fps(times),
                    "launches": n_kernel}
            if detail:
                launches[f"resize:{profile}/{w}x{h}"] = n_kernel
                first = c.first[ep + 1]
                want = _fresh_first_frame(profile, w, h, server.settings)
                check(first == want,
                      f"{profile} {w}x{h}: frame 1 differs from a fresh "
                      f"encoder's ({len(first)} vs {len(want)} messages)")
                step["first_frame_wire_bytes"] = sum(len(m) for m in first)
                step["first_frame_messages"] = len(first)
            st = server.display_clients["primary"]
            check((st.width, st.height) == (w, h), f"{profile}: geometry")
            steps[f"{w}x{h}"] = step
        return steps

    async def run(profile):
        settings = Settings(argv=[], env={"SELKIES_PORT": "0",
                                          "SELKIES_ENCODER": profile})
        server = DataStreamingServer(settings, device=DEVICE)
        try:
            c = _Client(server, {"displayId": "primary", "initialClientWidth": W,
                                 "initialClientHeight": H, "framerate": 60})
            t0 = time.monotonic()
            ok = await _until(lambda: len(c.in_epoch(1)) >= RESIZE_FRAMES, [c],
                              RESIZE_TIMEOUT_S)
            check(ok, f"{profile}: {len(c.in_epoch(1))} frames at 1080p")
            res = {"first_frame_after_settings_s": c.in_epoch(1)[0] - t0,
                   "resize_debounce_ms": int(settings.resize_debounce_ms),
                   "frames_per_s_1080p": _fps(c.in_epoch(1))}
            res["walk"] = await walk(server, c, profile, True)
            reserved1 = _reserved_mb()
            res["second_walk"] = await walk(server, c, profile, False)
            reserved2 = _reserved_mb()
            res["reserved_mb_after_walks"] = [reserved1, reserved2]
            check(reserved2 - reserved1 <= CHURN_GROWTH_MB,
                  f"{profile}: reserved memory grew from {reserved1} MB to "
                  f"{reserved2} MB over the second walk")
            # the storm: RESIZE_STORM resizes within 100 ms, the last one wins
            edge0 = dict(server.edge_stats)
            ep = c.epoch
            t0 = time.monotonic()
            storm = [(1280 + 64 * (k % 7), 720 + 36 * (k % 5))
                     for k in range(RESIZE_STORM - 1)] + [RESIZE_WALK[0]]
            for w, h in storm:              # all at once: well within 100 ms
                c.ws.feed(f"r,{w}x{h}")
            await _until(lambda: c.ws._incoming.empty(), [c], 10.0)
            fed_s = time.monotonic() - t0
            ok = await _until(lambda: len(c.in_epoch(ep + 1)) >= 5, [c],
                              RESIZE_TIMEOUT_S)
            await _until(lambda: False, [c], 0.5)
            runs = server.edge_stats["reconfigure_runs"] - edge0[
                "reconfigure_runs"]
            coal = server.edge_stats["reconfigure_coalesced"] - edge0[
                "reconfigure_coalesced"]
            st = server.display_clients["primary"]
            res["storm"] = {"resizes": RESIZE_STORM, "handled_in_s": fed_s,
                            "reconfigure_runs": runs,
                            "reconfigure_coalesced": coal,
                            "epochs": c.epoch - ep,
                            "geometry": [st.width, st.height],
                            "first_frame_s": (c.in_epoch(ep + 1)[0] - t0
                                              if ok else None)}
            check(ok and runs <= 2 and coal >= RESIZE_STORM - 2
                  and (st.width, st.height) == RESIZE_WALK[0],
                  f"{profile} storm: {res['storm']}")
            res.update(_served_state(server))
            res["edge_stats"] = dict(server.edge_stats)
            await c.ws.close()
            await asyncio.wait_for(c.task, 30.0)
        finally:
            await server.stop()
        _check_served(f"server_resize/{profile}", res)
        return res

    for profile in ("jpeg", "x264enc-striped", "x264enc"):
        out["profiles"][profile] = asyncio.run(run(profile))
    me_mc_stripes.launches = 0
    out["lane"] = asyncio.run(_lane_resize())
    launches["resize:mesh:x264enc-striped (server)"] = \
        out["lane"]["me_mc_launches"] = me_mc_stripes.launches
    out["lane_own_tickers"] = asyncio.run(_lane_resize(own_tickers=True))
    return out, launches


async def _lane_resize(own_tickers: bool = False) -> dict:
    """Four 1080p x264enc-striped displays from one lane; d0 resizes to
    the first RESIZE_WALK geometry: its first frame there comes from that
    geometry's bucket while d1-d3 keep streaming (frames in the second
    after the resize); then d0 resizes back into its old bucket, and the
    drained bucket is retired (its lane's planes freed). ``own_tickers``:
    each bucket's scheduler on a thread of its own, as in the JAX server,
    instead of the server's one LaneTicker (measured, not checked)."""
    from selkies_tpu_torch.server.data_server import (STATS_INTERVAL_S,
                                                      DataStreamingServer)
    from selkies_tpu_torch.settings import Settings

    from selkies_tpu_torch.parallel.coordinator import MeshEncodeCoordinator

    w, h = RESIZE_WALK[0]
    reserved0 = _reserved_mb()
    server = DataStreamingServer(Settings(argv=[], env=SERVER_MESH_ENV),
                                 device=DEVICE)
    try:
        if own_tickers:
            server.coordinator_factory = \
                lambda *a, ticker=None, **kw: MeshEncodeCoordinator(*a, **kw)
        views = [_Viewer(server, f"d{k}") for k in range(SERVER_MESH_DISPLAYS)]

        async def until(pred, timeout):
            t0 = time.monotonic()
            while not pred() and time.monotonic() - t0 < timeout:
                await asyncio.sleep(0.005)
                for v in views:
                    v.pump()
            return pred()

        ok = await until(lambda: all(len(v.frames) >= 15 for v in views),
                         SERVER_MESH_TIMEOUT_S)
        check(ok, "lane resize: " + str([len(v.frames) for v in views]))
        await until(lambda: False, 2.0)
        old = server.mesh_coordinators[(W, H, "x264enc-striped")]
        lag = {"max_ms": 0.0}

        async def loop_lag():
            # the event loop's longest stall while d0 moves bucket
            while True:
                t = time.monotonic()
                await asyncio.sleep(0.005)
                lag["max_ms"] = max(lag["max_ms"],
                                    (time.monotonic() - t - 0.005) * 1e3)

        t_r = time.monotonic()
        monitor = asyncio.create_task(loop_lag())
        views[0].ws.feed(f"r,{w}x{h},d0")
        ok = await until(lambda: any(e >= 2 for e, _, _ in views[0].frames),
                         SERVER_MESH_TIMEOUT_S)
        check(ok, "lane resize: d0 sent no frame at its new geometry")
        t_first = next(t for e, _, t in views[0].frames if e >= 2)
        await until(lambda: False, max(0.0, t_r + 1.0 - time.monotonic()))
        monitor.cancel()
        await until(lambda: False, max(0.0, t_first + 2.5 - time.monotonic()))

        def rate(v, t0, t1):
            return sum(1 for _, _, t in v.frames if t0 <= t < t1) / (t1 - t0)

        others = [sum(1 for _, _, t in v.frames if t_r <= t < t_r + 1.0)
                  for v in views[1:]]

        def longest_gap(v, t0, t1):
            ts = [t0] + [t for _, _, t in v.frames if t0 <= t < t1] + [t1]
            return max(b - a for a, b in zip(ts, ts[1:]))

        new = server.mesh_coordinators.get((w, h, "x264enc-striped"))
        res = {"resize_to": [w, h], "own_tickers": own_tickers,
               "first_frame_s": t_first - t_r,
               "loop_max_stall_ms": lag["max_ms"],
               "others_fps_before": [rate(v, t_r - 2.0, t_r) for v in views[1:]],
               "others_fps_two_lanes": [rate(v, t_first + 0.5, t_first + 2.5)
                                        for v in views[1:]],
               "d0_fps_new_bucket": rate(views[0], t_first + 0.5, t_first + 2.5),
               "others_frames_in_second_after": others,
               "others_frames_target": LANE_RESIZE_TARGET_FRAMES,
               "others_longest_gap_s": [longest_gap(v, t_r, t_r + 1.0)
                                        for v in views[1:]],
               "others_epochs": [v.epoch for v in views[1:]],
               "buckets": sorted(f"{a}x{b}/{p}"
                                 for a, b, p in server.mesh_coordinators),
               "sessions": [old.active_sessions,
                            new.active_sessions if new else None]}
        check(new is not None and res["sessions"] == [3, 1],
              f"lane resize: buckets {res}")
        print("lane resize:", json.dumps(res), file=sys.stderr, flush=True)
        # the cohabitants kept streaming: never restarted, and no freeze
        # longer than LANE_RESIZE_MAX_GAP_S in the second after the resize.
        # Their frame count there is reported against
        # LANE_RESIZE_TARGET_FRAMES: the host's share of two lanes' dispatch
        # sets it, and it varies with the host from call to call
        check(res["others_epochs"] == [1] * len(others)
              and max(res["others_longest_gap_s"]) <= LANE_RESIZE_MAX_GAP_S,
              f"lane resize: the cohabitants stalled: {res}")
        if own_tickers:                     # the comparison ends here
            for v in views:
                await v.ws.close()
                await asyncio.wait_for(v.task, 30.0)
            return res
        # back into the old bucket: the new one drains and its lane retires
        views[0].ws.feed(f"r,{W}x{H},d0")
        ok = await until(lambda: any(e >= 3 for e, _, _ in views[0].frames),
                         SERVER_MESH_TIMEOUT_S)
        check(ok, "lane resize: d0 sent no frame back at 1080p")
        t_back = time.monotonic()
        key = (w, h, "x264enc-striped")
        ok = await until(lambda: key not in server.mesh_coordinators,
                         2 * STATS_INTERVAL_S + new.lane_retire_s + 10.0)
        res["drained_bucket"] = {"retired": ok,
                                 "retired_after_s": time.monotonic() - t_back,
                                 "active_sessions": new.active_sessions}
        res["sessions_back"] = old.active_sessions
        check(ok and old.active_sessions == 4,
              f"lane resize: the drained bucket stayed: {res}")
        res["mesh_stats"] = dict(server.mesh_stats)
        for v in views:
            await v.ws.close()
            await asyncio.wait_for(v.task, 30.0)
    finally:
        await server.stop()
    res["reserved_mb_before_after"] = [reserved0, _reserved_mb()]
    check(res["mesh_stats"]["solo_fallback"] == 0,
          f"lane resize: solo fallback {res['mesh_stats']}")
    return res


#: server_edge: each fps window, and the stats feed's interval there
EDGE_WINDOW_S = 2.0
EDGE_STATS_INTERVAL_S = 1.0
EDGE_UPLOAD_MB = 64
EDGE_UPLOAD_CHUNK = 256 << 10


def phase_server_edge():
    """The wire edge on a 1080p JPEG display served through ws_handler, its
    source a scrolling desktop (every stripe of every frame changes, the
    media rate a slow consumer must keep up with): the
    owner (ACKing every frame) and a healthy viewer stream; their rates
    without, then with a viewer whose ``send`` blocks (a stalled
    consumer): it must be evicted (KILL slow_consumer, its socket closed)
    within slow_client_evict_s + 2 s, its send queue never deeper than
    max_send_queue; their rates after. A client sending
    protocol_error_budget + 1 malformed messages gets KILL
    protocol_abuse while the owner streams on. A 64 MiB upload in 0x01
    chunks lands byte for byte while the display streams (the owner's
    rate during it). The stats feed's ``gpu_stats`` reads the card.
    STATS_INTERVAL_S is shortened through the module attribute."""
    import tempfile

    import torch

    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag
    from selkies_tpu_torch.robustness import InProcessClient
    from selkies_tpu_torch.server import data_server
    from selkies_tpu_torch.settings import Settings

    class StalledClient(InProcessClient):
        """A viewer that stops reading: once ``stall`` is set, its send
        never returns (a peer whose TCP window closed)."""

        stall = False

        async def send(self, message) -> None:
            if self.stall:
                await asyncio.Event().wait()
            await super().send(message)

    async def run(upload_dir):
        settings = Settings(argv=[], env={"SELKIES_PORT": "0",
                                          "SELKIES_ENCODER": "jpeg"})
        server = data_server.DataStreamingServer(
            settings, device=DEVICE,
            source_factory=lambda w, h, fps: SyntheticSource(
                w, h, fps, pattern="scroll"))
        try:
            owner = _Client(server, {"displayId": "primary",
                                     "initialClientWidth": W,
                                     "initialClientHeight": H, "framerate": 60})
            viewer = _Client(server, ack=False)
            clients = [owner, viewer]
            ok = await _until(lambda: len(owner.frames) >= 30
                              and len(viewer.frames) >= 10, clients, 120.0)
            check(ok, "server_edge: the display did not stream")

            async def window(secs):
                t0 = time.monotonic()
                await _until(lambda: False, clients, secs)
                t1 = time.monotonic()
                return {"owner": owner.between(t0, t1) / (t1 - t0),
                        "viewer": viewer.between(t0, t1) / (t1 - t0)}

            res = {"phase": "server_edge", "profile": "jpeg", "width": W,
                   "height": H, "max_send_queue": int(settings.max_send_queue),
                   "slow_client_evict_s": int(settings.slow_client_evict_s),
                   "protocol_error_budget": int(settings.protocol_error_budget)}
            res["fps_without_stalled"] = await window(EDGE_WINDOW_S)

            stalled = _Client(server, ws=StalledClient(), ack=False)
            clients.append(stalled)
            ok = await _until(lambda: len(stalled.frames) >= 1
                              and stalled.ws in server._send_queues, clients,
                              30.0)
            check(ok, "server_edge: the stalled viewer never streamed")
            q = server._send_queues[stalled.ws].q
            depth = {"max": 0, "max_video": 0, "control_offered": 0}
            offer = q.offer

            def offer_and_measure(message, control=False):
                r = offer(message, control)
                depth["max"] = max(depth["max"], len(q))
                depth["max_video"] = max(depth["max_video"], q.video_len)
                depth["control_offered"] += bool(control)
                return r

            q.offer = offer_and_measure
            t_stall = time.monotonic()
            stalled.ws.stall = True
            # evicted: the server gives up on it and sends KILL slow_consumer
            # (a send the stalled peer never completes: the socket is closed
            # 1 s later)
            ok = await _until(
                lambda: server.edge_stats["slow_client_evictions"] >= 1,
                clients, res["slow_client_evict_s"] + 10.0)
            t_evict = time.monotonic()
            ok = await _until(lambda: stalled.ws.closed, clients, 10.0) and ok
            t_closed = time.monotonic()
            res["fps_with_stalled"] = {
                "owner": owner.between(t_stall, t_evict) / (t_evict - t_stall),
                "viewer": viewer.between(t_stall, t_evict) / (t_evict - t_stall)}
            res["stalled"] = {"evicted_after_s": t_evict - t_stall,
                              "closed_after_s": t_closed - t_stall,
                              "first_drop_after_s": (q.overflow_since - t_stall
                                                     if q.overflow_since
                                                     else None),
                              "evictions": server.edge_stats[
                                  "slow_client_evictions"],
                              "queue_depth_max": depth["max"],
                              "queue_video_max": depth["max_video"],
                              "control_offered": depth["control_offered"],
                              "video_dropped": q.dropped_video_total}
            check(ok and res["stalled"]["evictions"] == 1
                  and t_evict - t_stall <= res["slow_client_evict_s"] + 2.0,
                  f"server_edge: stalled viewer: {res['stalled']}")
            # max_send_queue bounds the media in the queue; control messages
            # (the stats feed) are never dropped and come on top
            check(depth["max_video"] <= res["max_send_queue"]
                  and depth["max"] <= res["max_send_queue"]
                  + depth["control_offered"],
                  f"server_edge: the stalled queue grew past max_send_queue: "
                  f"{res['stalled']}")
            await asyncio.wait_for(stalled.task, 30.0)
            clients.remove(stalled)
            res["fps_after_eviction"] = await window(EDGE_WINDOW_S)

            # the abuser: protocol_error_budget + 1 malformed messages
            abuser = _Client(server, ack=False)
            clients.append(abuser)
            await _until(lambda: abuser.texts, clients, 10.0)
            n0 = len(owner.frames)
            for _ in range(res["protocol_error_budget"] + 1):
                abuser.ws.feed(b"\xee not a client message")
            ok = await _until(lambda: abuser.ws.closed, clients, 30.0)
            await _until(lambda: len(owner.frames) > n0 + 30, clients, 30.0)
            res["abuser"] = {"killed": "KILL protocol_abuse" in abuser.texts,
                             "protocol_errors":
                                 server.edge_stats["protocol_errors"],
                             "owner_frames_meanwhile": len(owner.frames) - n0}
            check(ok and res["abuser"]["killed"]
                  and res["abuser"]["owner_frames_meanwhile"] > 30,
                  f"server_edge: abuser: {res['abuser']}")
            await asyncio.wait_for(abuser.task, 30.0)
            clients.remove(abuser)

            # the upload, while the display streams
            data = np.random.default_rng(9).bytes(EDGE_UPLOAD_MB << 20)
            up = _Client(server, ack=False)
            clients.append(up)
            await _until(lambda: up.texts, clients, 10.0)
            t0 = time.monotonic()
            up.ws.feed(f"FILE_UPLOAD_START:smoke/upload.bin:{len(data)}")
            for k in range(0, len(data), EDGE_UPLOAD_CHUNK):
                up.ws.feed(b"\x01" + data[k:k + EDGE_UPLOAD_CHUNK])
            up.ws.feed("FILE_UPLOAD_END:smoke/upload.bin")
            ok = await _until(lambda: up.ws._incoming.empty()
                              and not server._uploads, clients, 120.0)
            t1 = time.monotonic()
            # the owner's rate over a window that holds the whole upload
            await _until(lambda: False, clients, t0 + EDGE_WINDOW_S - t1)
            t2 = max(t1, time.monotonic())
            path = os.path.join(upload_dir, "smoke", "upload.bin")
            with open(path, "rb") as fh:
                equal = fh.read() == data
            res["upload"] = {"bytes": len(data), "chunk": EDGE_UPLOAD_CHUNK,
                             "seconds": t1 - t0, "equal": equal,
                             "owner_fps_window_s": t2 - t0,
                             "owner_fps_during": owner.between(t0, t2) / (t2 - t0),
                             "upload_paced": server.edge_stats["upload_paced"],
                             "errors": [t for t in up.texts
                                        if t.startswith("FILE_UPLOAD_ERROR")]}
            check(ok and equal and not res["upload"]["errors"],
                  f"server_edge: upload: {res['upload']}")
            await up.ws.close()
            await asyncio.wait_for(up.task, 30.0)
            clients.remove(up)

            # the stats feed's gpu_stats
            ok = await _until(lambda: any('"gpu_stats"' in t
                                          for t in owner.texts), clients,
                              EDGE_STATS_INTERVAL_S * 3 + 5.0)
            check(ok, "server_edge: no gpu_stats in the stats feed")
            gpu = next(json.loads(t) for t in reversed(owner.texts)
                       if '"gpu_stats"' in t)
            net = next(json.loads(t) for t in reversed(owner.texts)
                       if '"network_stats"' in t)
            res["gpu_stats"] = gpu
            res["network_stats"] = net
            check(gpu["bytes_in_use"] > 0
                  and gpu["device_count"] == torch.cuda.device_count()
                  and gpu["bytes_limit"] > gpu["bytes_in_use"],
                  f"server_edge: gpu_stats {gpu}")
            res["edge_stats"] = dict(server.edge_stats)
            res.update(_served_state(server))
            for c in (owner, viewer):
                await c.ws.close()
                await asyncio.wait_for(c.task, 30.0)
        finally:
            await server.stop()
        return res

    interval = data_server.STATS_INTERVAL_S
    data_server.STATS_INTERVAL_S = EDGE_STATS_INTERVAL_S
    prev_dir = os.environ.get("SELKIES_UPLOAD_DIR")
    dct8_quant_zigzag.launches = 0
    try:
        with tempfile.TemporaryDirectory() as d:
            os.environ["SELKIES_UPLOAD_DIR"] = d
            res = asyncio.run(run(d))
    finally:
        data_server.STATS_INTERVAL_S = interval
        if prev_dir is None:
            os.environ.pop("SELKIES_UPLOAD_DIR", None)
        else:
            os.environ["SELKIES_UPLOAD_DIR"] = prev_dir
    res["dct8_launches"] = dct8_quant_zigzag.launches
    _check_served("server_edge", res)
    check(res["dct8_launches"] > 0, "server_edge never launched dct8")
    return res


#: encoder_churn: cycles per profile, frames per cycle (the batched
#: encoder's: an IDR batch, then one batched dispatch), and the most the
#: reserved memory may grow from the 2nd cycle's reading to the last's
CHURN_CYCLES = 8
CHURN_FRAMES = 3
CHURN_BATCH = 4
CHURN_GROWTH_MB = 256


def phase_encoder_churn():
    """Displays joining and leaving: for each profile (and the H.264 host
    rung), CHURN_CYCLES times, build the served encoder (as the data server
    does), encode
    CHURN_FRAMES 1080p frames, close it and drop it; read the CUDA
    allocator's reserved memory after each cycle. With every encoder on
    the card's one stream a closed encoder's blocks serve the next, so the
    reading stops growing after the first cycles."""
    import gc

    import torch

    from selkies_tpu_torch.capture.synthetic import SyntheticSource

    src = SyntheticSource(W, H, pattern="scroll", seed=11)
    frames = [src.next_frame() for _ in range(2 * CHURN_BATCH)]
    out = {"phase": "encoder_churn", "width": W, "height": H,
           "cycles": CHURN_CYCLES, "frames_per_cycle": CHURN_FRAMES,
           "batched_frames_per_cycle": 2 * CHURN_BATCH, "reserved_mb": {}}
    for name, make, n in (
            ("jpeg", _pipeline, CHURN_FRAMES),
            ("x264enc-striped", _h264_pipeline, CHURN_FRAMES),
            ("x264enc", _fullframe_pipeline, CHURN_FRAMES),
            ("x264enc-striped/host",
             lambda: _served("x264enc-striped", "host"), CHURN_FRAMES),
            (f"x264enc-striped/batch{CHURN_BATCH}",
             lambda: _served("x264enc-striped", batch=CHURN_BATCH),
             2 * CHURN_BATCH)):
        readings = []
        for _ in range(CHURN_CYCLES):
            drv = make()[2]
            try:
                for f in frames[:n]:
                    while drv.try_submit(f) is None:
                        time.sleep(0.0005)
                results = drv.flush()
                st = drv.stats()
            finally:
                drv.close()
                drv.join(30.0)
            check(len(results) == n and st["encode_errors"] == 0,
                  f"churn {name}: {len(results)} of {n} frames, {st}")
            del drv, results
            gc.collect()
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            readings.append((torch.cuda.memory_reserved() >> 20)
                            if DEVICE == "cuda" else 0)
        out["reserved_mb"][name] = readings
        check(readings[-1] - readings[1] <= CHURN_GROWTH_MB,
              f"churn {name}: reserved memory grew from {readings[1]} MB to "
              f"{readings[-1]} MB over {CHURN_CYCLES - 2} encoders")
    return out


#: webrtc: access units the main session streams (the source runs at
#: WEBRTC_FPS until they have arrived; frames the pipeline has no room for
#: are dropped at submit, as served), the source frame whose next_frame()
#: sets 2 Mbps (QP 34), the stand-in's PLI after this many access units,
#: and the access units of each of the two start/stop cycles after it
WEBRTC_FPS = 60
WEBRTC_AUS = 130
WEBRTC_MIN_AUS = 120
WEBRTC_QP_AT = 60
WEBRTC_PLI_AT = 100
WEBRTC_PLI_WITHIN = 3
WEBRTC_CYCLE_FRAMES = 10
WEBRTC_TIMEOUT_S = 60.0


class _WebRTCSource:
    """1080p scroll frames (every frame damages the one stripe), recorded;
    at frame ``qp_at`` it sets the app's bitrate to 2 Mbps before it
    returns that frame, so the frame's dispatch takes the new QP."""

    def __init__(self, app, qp_at=None):
        from selkies_tpu_torch.capture.synthetic import SyntheticSource

        self.app, self.qp_at = app, qp_at
        self.src = SyntheticSource(W, H, WEBRTC_FPS, pattern="scroll",
                                   seed=3)
        self.frames = []

    def next_frame(self):
        if len(self.frames) == self.qp_at:
            self.app.set_video_bitrate(2_000_000)
        f = self.src.next_frame()
        self.frames.append(f)
        return f


class _RtpLoopbackSender:
    """The video sender of :class:`_RtpLoopbackPeer`: the port's H.264
    payloader, the RTP packets serialised and parsed, and the port's
    depayloader, which hands each access unit to ``on_frame``."""

    def __init__(self, on_frame):
        from selkies_tpu_torch.webrtc.h264 import (H264Depayloader,
                                                   H264Payloader)

        self.ssrc, self.seq, self.on_frame = 0x5E1F, 0, on_frame
        self._pay, self._depay = H264Payloader(), H264Depayloader()

    def send_frame(self, au: bytes, ts: int) -> None:
        from selkies_tpu_torch.webrtc.rtp import RtpPacket

        pkts = self._pay.packetize(au, self.ssrc, 102, self.seq, ts)
        self.seq = (self.seq + len(pkts)) & 0xFFFF
        for p in pkts:
            out = self._depay.feed(RtpPacket.parse(p.serialize()))
            if out is not None:
                self.on_frame(out, p.timestamp)


class _RtpLoopbackPeer:
    """The app's peer where ``cryptography`` is absent (no DTLS): video
    through :class:`_RtpLoopbackSender`; audio and the data channel go
    nowhere; an RTCP PLI is serialised, parsed and handed to
    ``on_keyframe_request`` as the peer connection does."""

    def __init__(self, on_frame):
        import types

        self.video = _RtpLoopbackSender(on_frame)
        self.on_bitrate = self.on_keyframe_request = None
        self._null = types.SimpleNamespace(
            send_frame=lambda *a: None, open=False, on_message=None,
            on_open=None, ssrc=0)

    def add_video_sender(self):
        return self.video

    def add_audio_sender(self):
        return self._null

    def create_data_channel(self, *a, **k):
        return self._null

    async def create_offer(self) -> str:
        return ""

    async def wait_connected(self, timeout: float = 15.0) -> None:
        return None

    def pli(self) -> None:
        from selkies_tpu_torch.webrtc.rtp import RtcpPli, parse_rtcp

        for pkt in parse_rtcp(RtcpPli(1, self.video.ssrc).serialize()):
            if isinstance(pkt, RtcpPli) and self.on_keyframe_request:
                self.on_keyframe_request()

    async def close(self) -> None:
        return None


def _nal_types(au: bytes):
    return [au[i + 4] & 0x1F for i in range(len(au) - 4)
            if au[i:i + 4] == b"\x00\x00\x00\x01"]


async def _webrtc_session(n_aus: int, qp_at=None, pli_at=None) -> dict:
    """One session of the port's WebRTCStreamingApp (its default encoder:
    one stripe over the frame, on the card) to a browser stand-in on
    127.0.0.1, SDP exchanged in-process, until ``n_aus`` access units have
    arrived; the congestion controller's estimates are recorded, not
    applied, so the QP changes only where the source changes it. Returns
    what was sent, received and dispatched."""
    from selkies_tpu_torch.server.webrtc_app import WebRTCStreamingApp

    got, sent, dispatch_ms, estimates, pli = [], {}, [], [], {}

    def on_frame(au, ts):
        got.append((au, ts, time.perf_counter()))

    try:
        import cryptography  # noqa: F401

        transport = "dtls-srtp"
    except ImportError:
        transport = "rtp-loopback: no cryptography"

    class App(WebRTCStreamingApp):
        def _new_peer(self):
            if transport == "dtls-srtp":
                return super()._new_peer()
            return _RtpLoopbackPeer(on_frame)

    import types

    holder = {}
    settings = types.SimpleNamespace(initial_width=W, initial_height=H,
                                     framerate=WEBRTC_FPS)
    app = App(settings, interfaces=["127.0.0.1"], device=DEVICE,
              source_factory=lambda w, h, fps: holder.setdefault(
                  "src", _WebRTCSource(app, qp_at)))
    t0 = time.perf_counter()
    await app.start_pipeline()
    enc, src = app.encoder, holder["src"]
    adopted = []
    enc.adopt = lambda f, _a=enc.adopt: (adopted.append(f), _a(f))[1]

    def timed(rgb, fetch, _d=enc._dispatch):
        t = time.perf_counter()
        try:
            return _d(rgb, fetch)
        finally:
            dispatch_ms.append((time.perf_counter() - t) * 1e3)
    enc._dispatch = timed
    send = app.video_sender.send_frame

    def record_send(au, ts):
        sent[ts] = (au, time.perf_counter())
        send(au, ts)
    app.video_sender.send_frame = record_send
    app.pc.on_bitrate = estimates.append
    on_key = app.pc.on_keyframe_request

    def keyframe_request():
        pli.setdefault("adopted_at_request", len(adopted))
        on_key()
    app.pc.on_keyframe_request = keyframe_request

    browser = None
    if transport == "dtls-srtp":
        from selkies_tpu_torch.webrtc.peerconnection import PeerConnection

        browser = PeerConnection(interfaces=["127.0.0.1"])
        browser.video_receiver().on_frame = on_frame
        await browser.set_remote_description(await app.pc.create_offer(),
                                             "offer")
        await app._on_sdp("answer", await browser.create_answer())
    try:
        deadline = time.perf_counter() + WEBRTC_TIMEOUT_S
        while len(got) < n_aus and time.perf_counter() < deadline:
            if pli_at is not None and len(got) >= pli_at and not pli:
                pli["aus_at_request"] = len(got)
                if browser is not None:
                    browser.request_keyframe(app.video_sender.ssrc)
                else:
                    app.pc.pli()
            check(app.error is None, f"webrtc pipeline failed: {app.error!r}")
            await asyncio.sleep(0.005)
        wall = time.perf_counter() - t0
    finally:
        await app.stop_pipeline()
        if browser is not None:
            await browser.close()
    check(app.error is None, f"webrtc pipeline failed: {app.error!r}")
    return {"transport": transport, "got": got, "sent": sent,
            "adopted": adopted, "frames": src.frames,
            "dispatch_ms": dispatch_ms, "estimates": estimates, "pli": pli,
            "wall_s": wall, "qp": enc.qp}


def _webrtc_reference(adopted, idr_at, qp_from) -> list:
    """A fresh port encoder on the card, as the app builds it, one frame
    at a time over the frames the app dispatched: QP 34 from ``qp_from``
    on, a keyframe requested before each frame in ``idr_at``."""
    from selkies_tpu_torch.encoder.h264 import H264StripeEncoder
    from selkies_tpu_torch.server.webrtc_app import bitrate_to_qp

    enc = H264StripeEncoder(W, H, stripe_height=-(-H // 16) * 16,
                            device=DEVICE)
    out = []
    for k, f in enumerate(adopted):
        if k == qp_from:
            enc.qp = bitrate_to_qp(2_000_000)
        if k in idr_at:
            enc.request_keyframe()
        out.append(b"".join(s.annexb for s in enc.encode_frame(f)))
    return out


def phase_webrtc():
    """The WebRTC mode on the card: the port's WebRTCStreamingApp at
    1920x1080 and 60 fps (H264StripeEncoder, one stripe of 1088 rows,
    behind PipelinedH264Encoder(depth=3, fetch_group=1)) streams scroll
    frames to a browser stand-in PeerConnection on 127.0.0.1 over
    ICE/DTLS-SRTP (or, without ``cryptography``, through the H.264
    payloader and depayloader alone). Checks: at least WEBRTC_MIN_AUS
    access units arrive, each equal to the one the app handed to
    send_frame, RTP timestamps seq*90000/60; every arrived AU equals a
    fresh synchronous encoder's over the frames the app dispatched, with
    QP 34 from the frame whose next_frame() set 2 Mbps; a PLI from the
    stand-in gets an IDR within WEBRTC_PLI_WITHIN dispatched frames; two
    more start/stop cycles leave the reserved memory flat. Returns the
    phase's line and the main session's me_mc launches."""
    import gc

    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes

    t_phase = time.perf_counter()
    dct8_quant_zigzag.launches = me_mc_stripes.launches = 0
    run = asyncio.run(_webrtc_session(WEBRTC_AUS, qp_at=WEBRTC_QP_AT,
                                      pli_at=WEBRTC_PLI_AT))
    launches = me_mc_stripes.launches
    got, sent, adopted = run["got"], run["sent"], run["adopted"]
    step = 90000 // WEBRTC_FPS
    check(len(got) >= WEBRTC_MIN_AUS,
          f"webrtc: {len(got)} access units arrived, {WEBRTC_MIN_AUS} "
          "expected")
    seqs = [ts // step for _, ts, _ in got]
    check(seqs == list(range(len(got))) and all(ts % step == 0
                                                for _, ts, _ in got),
          f"webrtc: RTP timestamps are not seq*{step}: {seqs[:12]}...")
    check(all(sent.get(ts, (None,))[0] == au for au, ts, _ in got),
          "webrtc: an arrived AU differs from the one handed to send_frame")
    idr = [k for k, (au, _, _) in enumerate(got) if 5 in _nal_types(au)]
    p_sent = len(got) - len(idr)
    check(dct8_quant_zigzag.launches == 0, "the WebRTC path launched dct8")
    # the QP change: the first dispatched frame at or after WEBRTC_QP_AT
    src_index = {id(f): k for k, f in enumerate(run["frames"])}
    qp_from = next(j for j, f in enumerate(adopted)
                   if src_index[id(f)] >= WEBRTC_QP_AT)
    want = _webrtc_reference(adopted[:len(got)], set(idr) - {0}, qp_from)
    n_equal = sum(a == b for (a, _, _), b in zip(got, want))
    check(n_equal == len(got), f"webrtc: {len(got) - n_equal} of {len(got)} "
          "AUs differ from a fresh synchronous encoder's (QP 34 from "
          f"frame {qp_from})")
    check(run["qp"] == 34, f"webrtc: the encoder's QP is {run['qp']}")
    pli = run["pli"]
    req = pli.get("adopted_at_request")
    # the frame handed over as the request came in may take it already
    after = [k for k in idr if req is not None and k >= req - 1]
    check(bool(after) and after[0] - req < WEBRTC_PLI_WITHIN,
          f"webrtc: no IDR within {WEBRTC_PLI_WITHIN} frames of the PLI "
          f"({pli}, IDRs at {idr})")
    lat = sorted((t_got - sent[ts][1]) * 1e3 for _, ts, t_got in got)
    arrive = [t for _, _, t in got]
    gc.collect()
    reserved = [_reserved_mb()]
    for _ in range(2):
        cyc = asyncio.run(_webrtc_session(WEBRTC_CYCLE_FRAMES))
        check(len(cyc["got"]) >= WEBRTC_CYCLE_FRAMES,
              f"webrtc cycle: {len(cyc['got'])} AUs")
        del cyc
        gc.collect()
        reserved.append(_reserved_mb())
    check(max(reserved) - reserved[0] <= CHURN_GROWTH_MB,
          f"webrtc: reserved memory grew {reserved} MB over start/stop")
    check(dct8_quant_zigzag.launches == 0, "the WebRTC path launched dct8")
    disp = sorted(run["dispatch_ms"])
    return {
        "phase": "webrtc", "width": W, "height": H, "fps": WEBRTC_FPS,
        "transport": run["transport"],
        "stripe": f"[1,{-(-H // 16) * 16},{W}]",
        "aus_received": len(got), "aus_equal_to_sent": len(got),
        "aus_equal_to_fresh_encoder": n_equal,
        "frames_dispatched": len(adopted),
        "frames_from_source": len(run["frames"]),
        "idr_at": idr, "p_frames_sent": p_sent,
        "me_mc_launches": launches,
        "dct8_launches": dct8_quant_zigzag.launches,
        "qp_from_frame": qp_from, "qp_after": run["qp"],
        "pli": {**pli, "idr_at_dispatched_frame": after[0],
                "frames_after_request": after[0] - req},
        "gcc_estimates": len(run["estimates"]),
        "gcc_last_bps": run["estimates"][-1] if run["estimates"] else None,
        "delivered_fps": (len(got) - 1) / (arrive[-1] - arrive[0]),
        "dispatch_ms_p50": disp[len(disp) // 2],
        "send_to_on_frame_ms_p50": lat[len(lat) // 2],
        "send_to_on_frame_ms_p95": lat[int(0.95 * (len(lat) - 1))],
        "reserved_mb_after_each_session": reserved,
        "session_s": run["wall_s"],
        "seconds": time.perf_counter() - t_phase,
    }, launches


#: harnesses: cavlc_fuzz's device mode over HARNESS_CAVLC_SEEDS seeds at
#: the tool's random geometries, then seeds at the 1080p shape of each
#: H.264 profile's encoder (its stripes and its stripe capacity)
HARNESS_CAVLC_SEEDS = 300
HARNESS_CAVLC_1080P = (("x264enc-striped", 20), ("x264enc", 10))
#: chaos_run: one storm of each mode at W x H, by seed. Seed 0's SFE storm
#: carries the owner's STOP_VIDEO in its first garbage burst (0.6 s in)
#: and draws no ws.drop after it, so no capture-side fault of it can fire
#: (the display captures nothing until the recovery presses play); seed 2
#: draws capture.raise, ws.drop and encode.raise in each mode and stops
#: no video
HARNESS_CHAOS_S = 8.0
HARNESS_CHAOS_FPS = 30.0
HARNESS_CHAOS_SEEDS = {"solo": 0, "mesh": 0, "sfe": 2}
#: swarm_run: tests/test_swarm.py's smoke, on the port's lane encoders
HARNESS_SWARM = {"n_clients": 32, "duration_s": 3.0, "seed": 1,
                 "concurrency": 12, "fps": 15.0, "slots_per_lane": 4,
                 "max_lanes": 2, "sick_slot": True}


def _harness_cavlc() -> dict:
    """cavlc_fuzz's device mode on the card: every stripe that is not
    flagged must equal the native coder bit for bit, every overflowed one
    must be flagged (the tool checks both). At the 1080p shapes the pack
    gets the stripe capacity the served encoder gives it."""
    from selkies_tpu_torch.encoder.h264 import H264StripeEncoder
    from selkies_tpu_torch.tools.cavlc_fuzz import check_device_seed

    t0 = time.perf_counter()
    runs = [("random", HARNESS_CAVLC_SEEDS, {"S": 2})]
    for profile, n in HARNESS_CAVLC_1080P:
        enc = H264StripeEncoder(W, H, stripe_height=STRIPE,
                                fullframe=profile == "x264enc", device=DEVICE)
        runs.append((profile, n, {
            "mb_w": enc.pad_w // 16, "mb_h": enc.stripe_h // 16,
            "S": enc.n_stripes, "max_stripe_bytes": enc._cavlc_msb}))
        del enc
    out, fails = {}, []
    for name, n, geom in runs:
        compared = flagged = 0
        for seed in range(n):
            ok, why, ovf = check_device_seed(seed, device=DEVICE, **geom)
            if not ok:
                fails.append(f"{name} seed {seed}: {why}")
            compared += geom["S"] - ovf
            flagged += ovf
        out[name] = {"seeds": n, **geom, "stripes_bit_exact": compared,
                     "stripes_flagged_overflow": flagged}
    check(not fails, f"harnesses: cavlc_fuzz failed: {fails[:5]}")
    return {"phase": "harnesses/cavlc_fuzz", "gpu": CARD.get("name_power"),
            "seeds": sum(n for _, n, _ in runs), "failures": len(fails),
            "stripes_bit_exact": sum(v["stripes_bit_exact"]
                                     for v in out.values()),
            "stripes_flagged_overflow": sum(v["stripes_flagged_overflow"]
                                            for v in out.values()),
            "by_geometry": out, "seconds": time.perf_counter() - t0}


def _harness_chaos(mode: str, devs) -> tuple:
    """One chaos_session storm at W x H on the card: solo, on a lane
    (``mesh``) or on an SFE lane of two stripe shards on ``devs``
    (``sfe``). Checks tests/test_robustness.py's chaos assertions, and
    that the served profile's kernel (dct8: the JPEG profile, on every
    rung and lane) launched during the storm beyond the tool's one
    warm-up frame, on every shard's device for ``sfe``. Launches counted
    from 0 just before, read just after."""
    import torch

    from selkies_tpu_torch.encoder.device_entropy import huffman_pack
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes
    from selkies_tpu_torch.tools.chaos_run import chaos_session

    kw = {"mesh": {"mesh": True},
          "sfe": {"sfe": True, "devices": devs}}.get(mode, {})
    reserved0 = _reserved_mb()
    t0 = time.perf_counter()
    _zero_counts()
    rep = asyncio.run(chaos_session(
        duration_s=HARNESS_CHAOS_S, seed=HARNESS_CHAOS_SEEDS[mode], width=W,
        height=H, fps=HARNESS_CHAOS_FPS, device=DEVICE, **kw))
    _sync(devs)
    launches = dct8_quant_zigzag.launches
    by_dev = {str(d): n for d, n in
              dct8_quant_zigzag.launches_by_device.items()}
    packs = huffman_pack.launches
    wall = time.perf_counter() - t0
    name = f"chaos:{mode}"
    check(rep["alive"], f"{name}: not alive: {rep}")
    check(bool(rep["injected"]), f"{name}: no fault injected")
    check(rep["failed_displays"] == 0, f"{name}: a display failed")
    check(rep["restarts"] + rep["watchdog_restarts"] + rep["reconnects"]
          >= 1, f"{name}: no restart, watchdog restart or reconnect: {rep}")
    check(rep["frames_delivered"] > 0, f"{name}: no frame delivered")
    check(me_mc_stripes.launches == 0, f"{name}: the JPEG path ran me_mc")
    check(DEVICE != "cuda" or launches > 1, f"{name}: {launches} dct8 "
          "launches (1 is the tool's warm-up frame)")
    if mode == "sfe":
        check(rep["mesh_sfe_shards"] == 2,
              f"{name}: {rep['mesh_sfe_shards']} shards")
        for d in set(devs) - {"cpu"}:
            check(by_dev.get(str(torch.device(d)), 0) > (d == devs[0]),
                  f"{name}: no dct8 launch on {d} in the storm ({by_dev})")
    return {"phase": f"harnesses/{name}", "gpu": CARD.get("name_power"),
            "width": W, "height": H, "fps": HARNESS_CHAOS_FPS,
            "devices": devs if mode == "sfe" else [DEVICE],
            "dct8_launches": launches, "dct8_launches_by_device": by_dev,
            "huffman_pack_launches": packs,
            "reserved_mb_before": reserved0,
            "reserved_mb_after": _reserved_mb(), "seconds": wall,
            "report": rep}, (by_dev if mode == "sfe" else launches)


def _harness_swarm() -> tuple:
    """swarm_run with the port's real lane encoders on the card: the
    tier-1 smoke's storm with a sick slot. Checks tests/test_swarm.py's
    assertions; launches counted from 0 just before, read just after."""
    from selkies_tpu_torch.encoder.device_entropy import huffman_pack
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag
    from selkies_tpu_torch.tools.swarm_run import swarm_run

    reserved0 = _reserved_mb()
    t0 = time.perf_counter()
    _zero_counts()
    rep = asyncio.run(swarm_run(encoder="real", device=DEVICE,
                                **HARNESS_SWARM))
    _sync([DEVICE])
    launches = dct8_quant_zigzag.launches
    packs = huffman_pack.launches
    wall = time.perf_counter() - t0
    check(rep["swarm_clients"] >= HARNESS_SWARM["n_clients"],
          f"swarm: {rep['swarm_clients']} clients")
    check(rep["leaked_slots"] == 0, f"swarm: leaked slots: {rep}")
    check(rep["trace_open_spans"] == 0, f"swarm: open spans: {rep}")
    check(rep["slot_accounting_violations"] == [], f"swarm: {rep}")
    check(rep["victim_migrated"] is True, f"swarm: no migration: {rep}")
    check(rep["cohabitants_stalled"] == 0, f"swarm: stalled: {rep}")
    check(rep["quarantined_slots"] + rep.get("migrations", 0) >= 1,
          f"swarm: {rep}")
    check(rep["frames_delivered_total"] > 0, f"swarm: no frames: {rep}")
    check(rep["alive"] is True, f"swarm: not alive: {rep}")
    check(DEVICE != "cuda" or launches > 0,
          "swarm: the real lanes never launched dct8")
    return {"phase": "harnesses/swarm:real", "gpu": CARD.get("name_power"),
            "sessions_per_chip": rep["sessions_per_chip"],
            "fairness_jain_index": rep["fairness_jain_index"],
            "eviction_ms_p95": rep["eviction_ms_p95"],
            "dct8_launches": launches, "huffman_pack_launches": packs,
            "reserved_mb_before": reserved0,
            "reserved_mb_after": _reserved_mb(), "seconds": wall,
            "report": rep}, launches


def phase_harnesses():
    """The port's harnesses (selkies_tpu_torch/tools/) on the card: the
    CAVLC fuzzer's device mode, a 1080p fault storm of each chaos mode and
    a swarm over real lanes, each part printing its line as it ends.
    Every part closes what it opened (the tools stop their servers in
    their own ``finally``); no port thread may be left after the phase.
    Returns the phase's line and the launches by path."""
    t0 = time.perf_counter()
    devs = _md_devices()[0]
    lines = [_harness_cavlc()]
    emit(lines[-1])
    launches = {}
    for mode in ("solo", "mesh", "sfe"):
        line, launches[f"chaos:{mode}"] = _harness_chaos(mode, devs)
        check_no_port_threads(f"harnesses/chaos:{mode}")
        lines.append(line)
        emit(line)
    line, launches["swarm:real"] = _harness_swarm()
    check_no_port_threads("harnesses/swarm:real")
    emit(line)
    return {"phase": "harnesses", "gpu": CARD.get("name_power"),
            "parts": [ln["phase"] for ln in lines + [line]],
            "huffman_pack_launches": {
                ln["phase"].split("/", 1)[1]: ln["huffman_pack_launches"]
                for ln in lines[1:] + [line]},
            "seconds": time.perf_counter() - t0}, launches


#: h264_cross: the encoder configurations held card against CPU
CROSS_CONFIGS = {
    "x264enc-striped": dict(stripe_height=STRIPE, entropy="device"),
    "x264enc": dict(fullframe=True, entropy="device"),
    "x264enc-striped/host": dict(stripe_height=STRIPE, entropy="host"),
    "x264enc/host": dict(fullframe=True, entropy="host"),
}


def phase_h264_cross():
    """A short 1920x256 sequence (IDR, 3 scrolled P frames, static frames
    up to paint-over, a keyframe request, one more P frame) encoded on the
    card and on the CPU, striped and full-frame, with each entropy tier:
    every Annex-B stripe must be byte-equal."""
    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.encoder.h264 import H264StripeEncoder

    w, h = W, 256
    src = SyntheticSource(w, h, pattern="scroll", seed=7)
    frames = [src.next_frame() for _ in range(4)]
    frames += [frames[-1]] * 3 + [frames[-1], src.next_frame()]
    out = {"phase": "h264_cross", "width": w, "height": h,
           "frames": len(frames), "configs": {}}
    for name, cfg in CROSS_CONFIGS.items():
        kw = dict(paint_over_trigger_frames=2, **cfg)
        gpu = H264StripeEncoder(w, h, device=DEVICE, **kw)
        cpu = H264StripeEncoder(w, h, device="cpu", **kw)
        same = total = keys = 0
        paint_frames = 0
        for k, f in enumerate(frames):
            if k == 7:
                gpu.request_keyframe()
                cpu.request_keyframe()
            a, b = gpu.encode_frame(f), cpu.encode_frame(f)
            check([(s.y_start, s.is_key) for s in a]
                  == [(s.y_start, s.is_key) for s in b],
                  f"h264_cross {name} frame {k}: card and CPU emitted "
                  "different stripes")
            total += len(a)
            keys += sum(s.is_key for s in a)
            same += sum(x.annexb == y.annexb for x, y in zip(a, b))
            paint_frames += int(k in (4, 5, 6) and bool(a))
        check(same == total,
              f"h264_cross {name}: {same} of {total} stripes equal")
        check(keys == 2 * gpu.n_stripes and paint_frames == 1,
              f"h264_cross {name}: {keys} key stripes, {paint_frames} "
              "paint-over frames")
        check(gpu.entropy_errors_total == 0,
              f"h264_cross {name}: entropy errors")
        out["configs"][name] = {"stripes": total, "stripes_identical": same,
                                "key_stripes": keys,
                                "paint_over_frames": paint_frames,
                                "host_coded_stripes":
                                    gpu.host_coded_stripes_total}
    return out


def dct_planes_of(root: str) -> int:
    """Device time of each launch the port in checkout ``root`` makes for
    one 1080p noise frame's DCT (through its own encoder's planes): an
    older tree's per-plane launches, or this tree's single one."""
    import inspect

    import torch

    sys.path.insert(0, os.path.abspath(root))
    from selkies_tpu_torch.capture.synthetic import SyntheticSource
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder
    from selkies_tpu_torch.ops import dct_quant

    check(dct_quant.__file__.startswith(os.path.abspath(root)),
          f"imported {dct_quant.__file__}, not {root}'s")
    enc = JpegStripeEncoder(W, H, stripe_height=STRIPE, device=DEVICE)
    planes = _main_path_planes(
        SyntheticSource(W, H, pattern="noise", seed=1).next_frame(), enc)
    fn = dct_quant.dct8_quant_zigzag
    if len(inspect.signature(fn).parameters) == 3:
        def run():                          # one launch per plane
            for p in planes:
                fn(*p)
    else:
        def run():
            fn(planes)
    per_launch = launch_ms(run, 100)
    check(per_launch is not None, "profiler recorded no device time")
    emit({"phase": "dct_planes", "tree": root, "source": dct_quant.__file__,
          "gpu": torch.cuda.get_device_name(0), "per_launch_ms": per_launch,
          "total_ms": sum(per_launch)})
    return 0


#: server_trace: ACKed frames per profile, frames per lane display, the
#: profiler request's length, and the stats feed's period in the phase
TRACE_FRAMES = 120
TRACE_LANE_FRAMES = 60
TRACE_PROFILER_MS = 300
#: profiler requests a traced path may take before its trace must hold
#: the kernel. Only a request during which the path launched its kernel
#: and whose trace holds no kernel record of it is taken again: on an
#: H100 CUPTI drops every kernel record of some windows, up to 5 in a row
#: (PERF.md §6). A request during which the path launched nothing fails
#: the check at once
TRACE_TRIES = 8
TRACE_STATS_S = 1.0
TRACE_TIMEOUT_S = 120.0
#: the stages every ACKed span carries (``stage`` too where the frame is
#: staged from the host: the solo paths), in path order
TRACE_STAGES = ("capture", "dispatch", "fetch_wait", "pack", "queue",
                "send", "ack")
#: the device kernel each served profile runs, as torch.profiler names it
TRACE_KERNEL = {"jpeg": "dct8_quant_zigzag_kernel",
                "x264enc-striped": "me_mc_kernel",
                "x264enc": "me_mc_kernel"}


def _span_stats(spans) -> dict:
    """Stage p50/p95 ms, glass-to-glass p50/p95 and encode-only p50 of
    ACKed spans (FrameTrace objects)."""
    def pct(vals, q):
        vals = sorted(vals)
        return vals[min(len(vals) - 1, int(len(vals) * q / 100.0))] \
            if vals else None

    from selkies_tpu_torch.observability import STAGES

    stages = {}
    for stage in STAGES:
        d = [t.duration_ms(stage) for t in spans if stage in t.spans]
        if d:
            stages[stage] = {"p50_ms": pct(d, 50), "p95_ms": pct(d, 95),
                             "n": len(d)}
    g2g = [t.total_ms for t in spans]
    enc = [e for t in spans if (e := t.encode_only_ms) is not None]
    # time between the recorder's stages (a frame waiting in the driver's
    # submit queue, in the pipeline behind earlier frames, or for the
    # harvesting thread's next poll; a lane span names these waits in
    # LANE_STAGES, which overlap and are left out here)
    gaps = [t.total_ms - sum(t.duration_ms(st) for st in t.spans
                             if st in STAGES)
            for t in spans]
    return {"stages": stages, "glass_to_glass_p50_ms": pct(g2g, 50),
            "glass_to_glass_p95_ms": pct(g2g, 95),
            "encode_only_p50_ms": pct(enc, 50),
            "between_stages_p50_ms": pct(gaps, 50)}


def _check_spans(name: str, spans, staged: bool) -> None:
    """Every ACKed span carries each stage of its path, in time order
    (stage starts never decrease along the path)."""
    want = TRACE_STAGES[:1] + (("stage",) if staged else ()) \
        + TRACE_STAGES[1:]
    for t in spans:
        missing = [st for st in want if st not in t.spans]
        check(not missing, f"{name}: span {t.frame_id} lacks {missing}: "
              f"{sorted(t.spans)}")
        starts = [t.spans[st][0] for st in want]
        check(all(a <= b for a, b in zip(starts, starts[1:])),
              f"{name}: span {t.frame_id} out of order: "
              + str({st: t.spans[st] for st in want}))


def _http(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


async def _keep_acking(ws, seen: int) -> None:
    """ACK every frame the in-process client ``ws`` receives from message
    ``seen`` on, until cancelled (as a browser keeps doing)."""
    from selkies_tpu_torch.protocol.wire import unpack_binary

    last = None
    while True:
        await asyncio.sleep(0.002)
        for msg in ws.sent[seen:]:
            if isinstance(msg, (bytes, bytearray)):
                fid = unpack_binary(bytes(msg)).frame_id
                if fid != last:
                    ws.feed(f"CLIENT_FRAME_ACK {fid}")
                    last = fid
        seen = len(ws.sent)


async def _trace_capture(metrics, kernel: str, wrapper) -> dict:
    """A TRACE_PROFILER_MS request to the profiler route while the
    display streams (the viewer keeps ACKing): the trace it writes must
    hold a device event of the path's kernel ``kernel``, launched by
    ``wrapper``. Each request's readings are kept: the wrapper's launches
    during the request, the trace's device events, its kernel events of
    any name and of ``kernel``. A request in which the path launched no
    kernel fails at once (the display stalled); one in which it launched
    and the trace holds none of it is a window CUPTI lost, taken again
    up to TRACE_TRIES requests in all."""
    base = f"http://127.0.0.1:{metrics.http_port}"
    readings = []
    for _ in range(TRACE_TRIES):
        n0 = wrapper.launches
        code, body = await asyncio.to_thread(
            _http, f"{base}/debug/jax-trace?ms={TRACE_PROFILER_MS}")
        launched = wrapper.launches - n0
        check(code == 200, f"profiler route answered {code}")
        info = json.loads(body)
        with open(info["path"]) as f:
            events = json.load(f).get("traceEvents", [])
        kernels = [e for e in events if e.get("cat") == "kernel"]
        hits = [e for e in kernels if kernel in e.get("name", "")]
        readings.append({"launches": launched,
                         "device_events": info["device_events"],
                         "kernel_events": len(kernels),
                         "hits": len(hits)})
        if hits:
            return {"device_events": info["device_events"],
                    "kernel_events": len(hits), "attempts": len(readings),
                    "readings": readings,
                    "kernel_ms_in_trace": sum(e.get("dur", 0)
                                              for e in hits) / 1e3}
        check(launched > 0, f"the path launched no {kernel} during a "
              f"profiler request: {readings}")
    check(False, f"the profiler trace holds no {kernel} event in "
          f"{TRACE_TRIES} requests: {readings}")


def phase_server_trace():
    """The flight recorder and the metrics plane through the served
    paths: per profile (JPEG, x264enc-striped, x264enc at their device
    rungs) one 1080p display through ws_handler, wired as ``main()``
    wires it (``Metrics(port=0)`` with the server's recorder, the
    profiler route enabled, ``start_http``), every frame ACKed until
    TRACE_FRAMES are; the ACKed spans' stage breakdown, glass-to-glass and
    encode-only figures; ``/healthz``, ``/debug/trace`` and ``/metrics``;
    a profiler request while it streams; the client's ``system_health``
    with ``stages``; terminal marks and open spans after the display
    stops (0). Then four x264enc-striped displays on one lane. Launch
    counts from 0 just before each path, read just after. Returns (line,
    launches by path)."""
    import torch

    from selkies_tpu_torch.observability import metrics as obs_metrics
    from selkies_tpu_torch.observability import Metrics
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes
    from selkies_tpu_torch.protocol.wire import unpack_binary
    from selkies_tpu_torch.robustness import InProcessClient
    from selkies_tpu_torch.server import data_server
    from selkies_tpu_torch.settings import Settings

    def wire(server):
        m = Metrics(port=0)
        m.recorder = server.recorder
        m.jax_trace_enabled = True
        check(m.start_http(), "metrics endpoint did not bind")
        server.metrics = m
        server.recorder.metrics = m
        return m

    def terminals(rec) -> dict:
        out = {}
        for t in rec._completed():
            out[t.terminal] = out.get(t.terminal, 0) + 1
        return out

    async def solo(profile: str) -> dict:
        wire_type = SERVER_PHASES[profile][1]
        kernel = dct8_quant_zigzag if profile == "jpeg" else me_mc_stripes
        server = data_server.DataStreamingServer(
            Settings(argv=[], env={"SELKIES_PORT": "0",
                                   "SELKIES_ENCODER": profile}),
            device=DEVICE)
        m = wire(server)
        try:
            dct8_quant_zigzag.launches = me_mc_stripes.launches = 0
            ws = InProcessClient()
            task = asyncio.create_task(server.ws_handler(ws))
            ws.feed("SETTINGS," + json.dumps({
                "displayId": "primary", "initialClientWidth": W,
                "initialClientHeight": H, "framerate": 60}))
            acked, seen, health, t_first = [], 0, [], None
            t0 = time.monotonic()
            while len(acked) < TRACE_FRAMES \
                    and time.monotonic() - t0 < TRACE_TIMEOUT_S:
                await asyncio.sleep(0.002)
                for msg in ws.sent[seen:]:
                    if isinstance(msg, (bytes, bytearray)):
                        check(msg[0] == wire_type, f"{profile}: type {msg[0]}")
                        f = unpack_binary(bytes(msg))
                        if f.frame_id not in acked:
                            acked.append(f.frame_id)
                            t_first = t_first or time.monotonic()
                            ws.feed(f"CLIENT_FRAME_ACK {f.frame_id}")
                    elif '"system_health"' in msg:
                        health.append(json.loads(msg))
                seen = len(ws.sent)
            t_acked = time.monotonic() - (t_first or t0)
            check(len(acked) >= TRACE_FRAMES,
                  f"{profile}: {len(acked)} frames ACKed")
            # the display keeps streaming through the requests below: a
            # viewer that stopped ACKing would be paused by backpressure, and
            # a paused display launches no kernel for the profiler to record
            pump = asyncio.create_task(_keep_acking(ws, seen))
            await asyncio.sleep(0.1)            # the last ACKs land
            rec = server.recorder
            spans = [t for t in rec._completed() if t.terminal == "acked"]
            spans = sorted(spans, key=lambda t: t.t0)[:TRACE_FRAMES]
            _check_spans(profile, spans, staged=True)
            stats = _span_stats(spans)
            base = f"http://127.0.0.1:{m.http_port}"
            code, _ = await asyncio.to_thread(_http, base + "/healthz")
            check(code == 200, f"/healthz answered {code}")
            code, body = await asyncio.to_thread(
                _http, base + "/debug/trace?s=60")
            events = json.loads(body)["traceEvents"]
            check(code == 200 and any(
                e.get("ph") == "X" and e["args"]["display"] == "primary"
                for e in events), "/debug/trace holds no span of the display")
            code, body = await asyncio.to_thread(_http, base + "/metrics")
            if obs_metrics.HAVE_PROM:
                check(b"frame_stage_ms" in body and b"glass_to_glass_ms" in body,
                      "/metrics lacks the stage series")
            prof = await _trace_capture(m, TRACE_KERNEL[profile], kernel)
            while not any(d.get("stages") for h in health
                          for d in h["displays"].values()) \
                    and time.monotonic() - t0 < TRACE_TIMEOUT_S + 10:
                await asyncio.sleep(0.05)
                health += [json.loads(x) for x in ws.sent[seen:]
                           if isinstance(x, str) and '"system_health"' in x]
                seen = len(ws.sent)
            with_stages = [h for h in health
                           if h["displays"].get("primary", {}).get("stages")]
            check(with_stages, f"{profile}: no system_health with stages")
            st = server.display_clients["primary"]
            lad, sup = st.ladder.state(), st.supervisor.stats()
            check(lad["rung"] == "device" and lad["failures_total"] == 0
                  and sup["restarts_total"] == 0,
                  f"{profile}: encoder failed on the traced path: {lad} {sup}")
            pump.cancel()
            await asyncio.gather(pump, return_exceptions=True)
            await ws.close()
            await asyncio.wait_for(task, 30.0)
        finally:
            await server.stop()
            m.stop_http()
        launches = kernel.launches
        check(launches > 0, f"{profile}: the path launched no kernel")
        check(rec.open_spans() == 0,
              f"{profile}: {rec.open_spans()} spans open after stop")
        return {"profile": profile, "frames_acked": len(acked),
                "first_frame_s": t_first - t0,
                "frames_per_s_after_first": (len(acked) - 1) / t_acked,
                **stats, "fetch_wait_gt0": sum(
                    1 for t in spans if t.duration_ms("fetch_wait") > 0),
                "terminals": terminals(rec),
                "open_spans_after_stop": rec.open_spans(),
                "health_stages": with_stages[-1]["displays"]["primary"][
                    "stages"],
                "prometheus_client": obs_metrics.HAVE_PROM,
                "profiler": prof, "kernel_launches": launches}

    async def lane() -> dict:
        server = data_server.DataStreamingServer(
            Settings(argv=[], env=SERVER_MESH_ENV), device=DEVICE)
        m = wire(server)
        try:
            me_mc_stripes.launches = 0
            views = [_Viewer(server, f"d{k}")
                     for k in range(SERVER_MESH_DISPLAYS)]
            t0 = time.monotonic()
            while not all(len(v.frames) >= TRACE_LANE_FRAMES for v in views) \
                    and time.monotonic() - t0 < TRACE_TIMEOUT_S:
                await asyncio.sleep(0.005)
                for v in views:
                    v.pump()
            check(all(len(v.frames) >= TRACE_LANE_FRAMES for v in views),
                  "lane displays: " + str([len(v.frames) for v in views]))
            await asyncio.sleep(0.1)
            rec = server.recorder
            out = {}
            for v in views:
                spans = [t for t in rec._completed()
                         if t.terminal == "acked" and t.display == v.did]
                spans = sorted(spans, key=lambda t: t.t0)[:TRACE_LANE_FRAMES]
                check(len(spans) >= TRACE_LANE_FRAMES - 2,
                      f"lane {v.did}: {len(spans)} acked spans")
                _check_spans(f"lane {v.did}", spans, staged=False)
                out[v.did] = {k: ({s: x["p50_ms"] for s, x in val.items()}
                                  if k == "stages" else val)
                              for k, val in _span_stats(spans).items()}
                out[v.did]["frames_per_s"] = v.fps()
            coord = server.mesh_coordinators[(W, H, "x264enc-striped")]
            check(coord.stats()["lanes"] == 1, "the displays left the lane")
            for v in views:
                await v.ws.close()
                await asyncio.wait_for(v.task, 30.0)
        finally:
            await server.stop()
            m.stop_http()
        check(rec.open_spans() == 0,
              f"lane: {rec.open_spans()} spans open after stop")
        check(me_mc_stripes.launches > 0, "the lane launched no me_mc")
        return {"displays": out, "terminals": terminals(rec),
                "open_spans_after_stop": rec.open_spans(),
                "kernel_launches": me_mc_stripes.launches}

    async def x11() -> dict:
        from selkies_tpu_torch.capture.x11 import X11Source

        if not os.environ.get("DISPLAY") or not X11Source.available():
            return {"x11_capture": "no X display"}
        server = data_server.DataStreamingServer(
            Settings(argv=[], env={"SELKIES_PORT": "0",
                                   "SELKIES_ENCODER": "jpeg"}),
            device=DEVICE)
        try:
            ws = InProcessClient()
            task = asyncio.create_task(server.ws_handler(ws))
            ws.feed("SETTINGS," + json.dumps({
                "displayId": "primary", "initialClientWidth": W,
                "initialClientHeight": H, "framerate": 60}))
            acked, seen, t0 = set(), 0, time.monotonic()
            while len(acked) < 60 and time.monotonic() - t0 < TRACE_TIMEOUT_S:
                await asyncio.sleep(0.005)
                for msg in ws.sent[seen:]:
                    if isinstance(msg, (bytes, bytearray)):
                        f = unpack_binary(bytes(msg))
                        if f.frame_id not in acked:
                            acked.add(f.frame_id)
                            ws.feed(f"CLIENT_FRAME_ACK {f.frame_id}")
                seen = len(ws.sent)
            sup = server.display_clients["primary"].supervisor.stats()
            await ws.close()
            await asyncio.wait_for(task, 30.0)
        finally:
            await server.stop()
        check(len(acked) >= 60 and sup["failures_total"] == 0,
              f"x11 capture: {len(acked)} frames, {sup}")
        return {"x11_capture": {"frames_acked": len(acked),
                                "display": os.environ["DISPLAY"]}}

    t_phase = time.perf_counter()
    interval, data_server.STATS_INTERVAL_S = \
        data_server.STATS_INTERVAL_S, TRACE_STATS_S
    try:
        profiles = {p: asyncio.run(solo(p))
                    for p in ("jpeg", "x264enc-striped", "x264enc")}
        lane_out = asyncio.run(lane())
        x11_out = asyncio.run(x11())
    finally:
        data_server.STATS_INTERVAL_S = interval
    launches = {f"trace:{p} (server)": r["kernel_launches"]
                for p, r in profiles.items()}
    launches["trace:mesh:x264enc-striped (server)"] = \
        lane_out["kernel_launches"]
    return {"phase": "server_trace", "gpu": CARD.get("name_power"),
            "torch": torch.__version__, "width": W, "height": H,
            "profiles": profiles, "lane": lane_out, **x11_out,
            "seconds": time.perf_counter() - t_phase}, launches


#: the served phases served_against runs in each tree
SERVED_PROFILES = (("jpeg", 1), ("x264enc-striped", 1), ("x264enc", 1),
                   ("x264enc-striped", CHURN_BATCH))

#: what one process of served_against runs from a tree's root: that
#: tree's chip_smoke.py phase_setup, then phase_server for each profile
_SERVED_CODE = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
cs.phase_setup()
out = {}
for profile, batch in %r:
    r = cs.phase_server(profile, batch=batch)
    out[profile + ("/batch%%d" %% batch if batch > 1 else "")] = {
        k: r[k] for k in ("first_frame_s", "frames_per_s_after_first",
                          "frames_received")}
print("SERVED " + json.dumps(out))
""" % (SERVED_PROFILES,)


def served_against(other: str, pairs: int = 2) -> int:
    """The served phases (first frame after SETTINGS, frames/s) of this
    checkout and of ``other`` (another checkout of the repo), each in a
    process of its own started from its own root, in the order other,
    this, this, other, ... (``pairs`` of each): the host of a call
    varies, so two trees compare only within one call."""
    import torch

    other = os.path.abspath(other)
    check(os.path.isfile(os.path.join(other, "chip_smoke.py")),
          f"{other} holds no chip_smoke.py")
    order = []
    for k in range(pairs):
        order += [other, HERE] if k % 2 == 0 else [HERE, other]
    runs = {"this": [], "other": []}
    for root in order:
        out = subprocess.run([sys.executable, "-c", _SERVED_CODE], cwd=root,
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("SERVED ")]
        check(out.returncode == 0 and lines,
              f"served phases in {root} failed: {out.stderr[-2000:]}")
        runs["this" if root == HERE else "other"].append(
            json.loads(lines[0][len("SERVED "):]))
    emit({"phase": "served_against", "this": HERE, "other": other,
          "gpu": torch.cuda.get_device_name(0),
          "order": ["this" if r == HERE else "other" for r in order],
          **runs})
    return 0


def main() -> int:
    # an abort (SIGABRT, SIGSEGV) prints every thread's Python stack to
    # stderr before the process dies
    faulthandler.enable(all_threads=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dct-planes-of"]:
        return dct_planes_of(sys.argv[2])
    if sys.argv[1:2] == ["--served-against"]:
        return served_against(sys.argv[2], *map(int, sys.argv[3:4]))
    sys.path.insert(0, HERE)
    import selkies_tpu_torch  # noqa: F401  (absent beside a lone script)

    return run_phases()


def run_phases() -> int:
    """Every phase in turn, then the summary lines; 0 when every check
    held (a failed check raises SystemExit)."""
    import torch

    from selkies_tpu_torch.encoder.device_entropy import huffman_pack
    from selkies_tpu_torch.ops.dct_quant import dct8_quant_zigzag
    from selkies_tpu_torch.ops.me_mc import me_mc_stripes

    t_start = time.perf_counter()
    clock_hz = phase_setup()
    kern = phase_kernel_check()
    kern_me = phase_me_kernel_check(INT32_LANES * clock_hz)
    _settle("huffman_pack")
    kern_huff = phase_huffman_check()
    packs = kern_huff["launches_by_path"]

    def packs_since(path: str, n0: int) -> int:
        """huffman_pack's launches on ``path`` (since the count n0)."""
        packs[path] = huffman_pack.launches - n0
        return packs[path]

    # the JPEG path: launch counts from 0 just before it, read just after
    _settle("encoder")
    dct8_quant_zigzag.launches = me_mc_stripes.launches = 0
    huffman_pack.launches = 0
    enc = phase_encoder()
    enc_launches = dct8_quant_zigzag.launches
    check(enc_launches == enc["frames_dispatched"],
          f"{enc_launches} kernel launches for {enc['frames_dispatched']} "
          "frames (1 per frame expected)")
    enc["kernel_launches_per_frame"] = enc_launches / enc["frames_dispatched"]
    _settle("server")
    server = phase_server("jpeg")
    launches = dct8_quant_zigzag.launches
    server["kernel_launches"] = launches - enc_launches
    check(server["kernel_launches"] >= server["frames_received"],
          "server path did not run the kernel for every frame")
    kern["launches"] = launches
    check(launches > 0, "the JPEG path never launched dct8_quant_zigzag")
    check(me_mc_stripes.launches == 0, "the JPEG path launched me_mc")
    # each device step packs its frame once: two launches per dct8 launch
    check(packs_since("jpeg", 0) == 2 * launches,
          f"the JPEG path: {packs['jpeg']} huffman_pack launches for "
          f"{launches} dct8 launches (two per frame expected)")

    # the H.264 path: counts from 0 just before it, read just after
    _settle("h264_encoder")
    dct8_quant_zigzag.launches = me_mc_stripes.launches = 0
    h264 = phase_h264_encoder()
    h264_launches = me_mc_stripes.launches
    check(h264_launches == h264["p_frames_dispatched"],
          f"{h264_launches} me_mc launches for "
          f"{h264['p_frames_dispatched']} P frames (1 per P frame expected)")
    _settle("server_h264")
    server_h264 = phase_server("x264enc-striped")
    launches = me_mc_stripes.launches
    server_h264["me_mc_launches"] = launches - h264_launches
    check(server_h264["me_mc_launches"] >= server_h264["frames_received"] - 1,
          "H.264 server path did not run me_mc for every P frame")
    kern_me["launches"] = launches
    check(launches > 0, "the H.264 path never launched me_mc_stripes")
    check(dct8_quant_zigzag.launches == 0, "the H.264 path launched dct8")
    kern_me["launches_by_path"] = {"x264enc-striped": launches}
    kern["launches_by_path"] = {"jpeg": kern["launches"]}

    # the full-frame x264enc path: counts from 0 just before, read after
    _settle("h264_fullframe_encoder")
    dct8_quant_zigzag.launches = me_mc_stripes.launches = 0
    h264_full = phase_h264_encoder("x264enc")
    full_launches = me_mc_stripes.launches
    check(full_launches == h264_full["p_frames_dispatched"],
          f"x264enc: {full_launches} me_mc launches for "
          f"{h264_full['p_frames_dispatched']} P frames (1 per P frame)")
    _settle("server_fullframe")
    server_full = phase_server("x264enc")
    launches = me_mc_stripes.launches
    server_full["me_mc_launches"] = launches - full_launches
    check(server_full["me_mc_launches"] >= server_full["frames_received"] - 1,
          "x264enc server path did not run me_mc for every P frame")
    check(dct8_quant_zigzag.launches == 0, "the x264enc path launched dct8")
    kern_me["launches_by_path"]["x264enc"] = launches
    h264_full["noise_qp18"] = check_fullframe_large_payload()

    # batched H.264 with frames made on the card (both profiles, and the
    # host tier): counts from 0 just before, read just after
    _settle("h264_batch")
    dct8_quant_zigzag.launches = me_mc_stripes.launches = 0
    h264_batch, batch_launches = phase_h264_batch()
    check(dct8_quant_zigzag.launches == 0, "the batched path launched dct8")
    kern_me["launches_by_path"].update(batch_launches)
    _settle("server_h264_batch")
    me_mc_stripes.launches = 0
    alloc0 = _peak_mark()
    server_batch = phase_server("x264enc-striped", batch=CHURN_BATCH)
    server_batch["me_mc_launches"] = me_mc_stripes.launches
    server_batch.update(_peak_since(alloc0))
    check(server_batch["me_mc_launches"]
          >= server_batch["frames_received"] - 1,
          "batched server path did not run me_mc for every P frame")
    kern_me["launches_by_path"][
        f"x264enc-striped/batch{CHURN_BATCH} (server)"] = \
        server_batch["me_mc_launches"]

    # JPEG fed with frames made on the card: counts from 0 just before
    _settle("jpeg_device_frames")
    dct8_quant_zigzag.launches = me_mc_stripes.launches = 0
    p0 = huffman_pack.launches
    jpeg_dev, dev_launches = phase_jpeg_device_frames()
    check(packs_since("jpeg/device_frames (host and device frames)", p0)
          == 2 * dct8_quant_zigzag.launches,
          f"jpeg device frames: {huffman_pack.launches - p0} huffman_pack "
          f"launches for {dct8_quant_zigzag.launches} frames")
    check(dev_launches == 2 * (N_FRAMES + 1) and me_mc_stripes.launches == 0,
          f"jpeg device frames: {dev_launches} dct8 launches for "
          f"{2 * (N_FRAMES + 1)} frames")
    kern["launches_by_path"]["jpeg/device_frames"] = dev_launches

    # the host rungs, each its own path; then each against its device rung
    host = {}
    for profile, kernel, other, expect in (
            ("x264enc-striped", me_mc_stripes, dct8_quant_zigzag,
             "p_frames_dispatched"),
            ("jpeg", dct8_quant_zigzag, me_mc_stripes, "frames_dispatched")):
        _settle(f"host_rung/{profile}")
        dct8_quant_zigzag.launches = me_mc_stripes.launches = 0
        p0 = huffman_pack.launches
        out, runs = phase_host_rung(profile)
        check(packs_since(f"{profile}/host", p0) == 0,
              f"the {profile} host rung launched huffman_pack")
        launches = kernel.launches
        check(launches == out[expect] and other.launches == 0,
              f"{profile} host rung: {launches} launches for "
              f"{out[expect]} {expect}, {other.launches} of the other kernel")
        out["kernel_launches"] = launches
        (kern_me if kernel is me_mc_stripes else kern)[
            "launches_by_path"][f"{profile}/host"] = launches
        check_host_rung(profile, out, runs)
        host[profile] = out

    # the degradation ladder under injected faults: counts from 0 just
    # before the phase, read by rung while it runs
    _settle("server_faults")
    dct8_quant_zigzag.launches = me_mc_stripes.launches = 0
    p0 = huffman_pack.launches
    faults, by_rung = phase_server_faults()
    packs_since("x264enc-striped/ladder (phase)", p0)
    for rung in ("device", "host"):
        kern_me["launches_by_path"][f"x264enc-striped/ladder:{rung}"] = \
            by_rung[rung]["me_mc"]
    kern["launches_by_path"]["x264enc-striped/ladder:jpeg"] = \
        by_rung["jpeg"]["dct8_quant_zigzag"]

    # multi-session lanes: each lane's counts from 0 just before it, read
    # just after (mesh:<profile>/N<sessions>); then the served lane, from 0
    # just before the phase
    mesh, mesh_launches = phase_mesh_encoder()
    for path, n in mesh_launches.items():
        (kern if path.startswith("mesh:jpeg/") else kern_me)[
            "launches_by_path"][path] = n
    for lane in mesh["lanes"]:
        if lane["profile"] == "jpeg":
            packs[f"mesh:jpeg/N{lane['sessions']}"] = \
                lane["huffman_pack_launches"]
    _settle("server_mesh")
    dct8_quant_zigzag.launches = 0
    server_mesh = phase_server_mesh()
    check(dct8_quant_zigzag.launches == 0, "the H.264 lane launched dct8")
    kern_me["launches_by_path"]["mesh:x264enc-striped (server)"] = \
        server_mesh["me_mc_launches"]

    # lanes and split-frame encoding over two shards: each path's counts
    # from 0 just before it, read just after, by device
    _settle("multi_device")
    multi, multi_launches = phase_multi_device()
    emit(multi)
    for path, by_dev in multi_launches.items():
        (kern if path.startswith("multi:jpeg/") else kern_me)[
            "launches_by_path"][path] = by_dev
    for r in multi["lanes"] + multi["sfe"]:
        if r["profile"] == "jpeg":
            path = ("multi:jpeg/session:2" if "tpu_mesh" not in r
                    else f"multi:jpeg/sfe:{MD_SFE_MESH} (server)")
            packs[path] = r["huffman_pack_launches_by_device"]

    # resize: each step's counts from 0 just before its r, read just after
    _settle("server_resize")
    p0 = huffman_pack.launches
    server_resize, resize_launches = phase_server_resize()
    packs_since("resize (phase)", p0)
    emit(server_resize)
    for path, n in resize_launches.items():
        (kern if path.startswith("resize:jpeg/") else kern_me)[
            "launches_by_path"][path] = n
    # the wire edge: counts from 0 just before the phase
    _settle("server_edge")
    p0 = huffman_pack.launches
    server_edge = phase_server_edge()
    packs_since("edge:jpeg (server)", p0)
    emit(server_edge)
    kern["launches_by_path"]["edge:jpeg (server)"] = \
        server_edge["dct8_launches"]

    _settle("encoder_churn")
    churn = phase_encoder_churn()
    # the WebRTC mode: counts from 0 just before its main session, read
    # just after it
    _settle("webrtc")
    webrtc, webrtc_launches = phase_webrtc()
    emit(webrtc)
    check(webrtc_launches >= webrtc["p_frames_sent"],
          f"webrtc: {webrtc_launches} me_mc launches for "
          f"{webrtc['p_frames_sent']} P frames sent")
    kern_me["launches_by_path"]["webrtc:onestripe"] = webrtc_launches
    kern["launches_by_path"]["webrtc:onestripe"] = webrtc["dct8_launches"]
    # the harnesses: each storm's counts from 0 just before it, read just
    # after (chaos:<mode>, swarm:real)
    _settle("harnesses")
    harnesses, harness_launches = phase_harnesses()
    packs.update(harnesses["huffman_pack_launches"])
    emit(harnesses)
    kern["launches_by_path"].update(harness_launches)
    enc.update(phase_small_reference())
    cross = phase_h264_cross()
    _settle("profile")
    prof = phase_profile(_pipeline, "dct8_quant_zigzag", "profile")
    _settle("profile_h264")
    prof_h264 = phase_profile(_h264_pipeline, "me_mc_kernel", "profile_h264")
    _settle("profile_fullframe")
    prof_full = phase_profile(_fullframe_pipeline, "me_mc_kernel",
                              "profile_fullframe")
    # the flight recorder through each served path and a lane: counts
    # from 0 just before each path, read just after. Last: its profiler
    # request must not overlap the timing phases' profiler windows
    _settle("server_trace")
    p0 = huffman_pack.launches
    server_trace, trace_launches = phase_server_trace()
    packs_since("server_trace (phase)", p0)
    for path, n in trace_launches.items():
        (kern if path.startswith("trace:jpeg") else kern_me)[
            "launches_by_path"][path] = n

    emit({"kernels": [kern, kern_me, kern_huff]})
    emit(enc)
    emit(h264)
    emit(h264_full)
    emit(host["x264enc-striped"])
    emit(host["jpeg"])
    emit(server)
    emit(server_h264)
    emit(server_full)
    emit(h264_batch)
    emit(server_batch)
    emit(faults)
    emit(mesh)
    emit(server_mesh)
    emit(jpeg_dev)
    emit(churn)
    emit(cross)
    emit(prof)
    emit(prof_h264)
    emit(prof_full)
    emit(server_trace)
    # every server, ticker, pipeline and profiler of the phases is closed:
    # no thread of the port runs, every device used is idle, and stdout is
    # flushed before the last line; the process then ends by returning
    check_no_port_threads("the last phase")
    for d in sorted({"cuda:0", *_md_devices()[0]}):
        torch.cuda.synchronize(d)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "settled": SETTLED, "profiler": PROFILER,
          "threads_at_end": sorted(t.name for t in threading.enumerate())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
