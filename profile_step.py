#!/usr/bin/env python3
"""Where the time of one main-path fleet step goes, on one CUDA GPU.

Builds chip_smoke.py's main path (bench.py's configuration: K=50 condensed,
n = m = 52, B = 8192, float32, backend "cuda"), runs WARMUP closed-loop steps,
then

  1. times each stage with a synchronise after it, medians over STAGE_STEPS
     steps: the vectors-only template transcription, the condensed QPs
     (transcription and GEMMs), the solve (preparation, kernel, finalize) and
     the whole step;
  2. traces PROFILE_STEPS steps with torch.profiler.  The device time is the
     sum of the durations of the device-side events (kernels, copies, sets),
     each counted once; the busy share is that time over the wall time of the
     same number of steps run without the profiler.

Writes the profiler's table to chiprun_out/profile_table.txt.

Run from the repository root:  python3 profile_step.py
"""

import os
import sys
import time

import numpy as np
import torch

WARMUP = 40
STAGE_STEPS = 40
PROFILE_STEPS = 10
KERNEL_NAME = "admm_shared_kernel"


def main():
    import chip_smoke as cs

    cs.device_phase()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.build_phase()
    from smooth_feedback_tpu_torch.qp import solve_qp_batch

    step, ws0 = cs.make_main_path("cuda", dev)
    B, DT = cs.B, cs.DT
    xs = cs.initial_states(dev)
    ws = type(ws0)(*(a.expand((B,) + a.shape).contiguous() for a in ws0))
    i = 0

    def advance():
        nonlocal xs, ws, i
        r = step.fleet_shared_t(ws, DT * i, xs)
        xs = xs + DT * torch.stack([xs[:, 1], r.u[:, 0]], dim=1)
        ws = r.warmstart
        i += 1

    for _ in range(WARMUP):
        advance()
    torch.cuda.synchronize()

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    stages = {"transcribe_vectors": [], "condensed_qp": [], "solve_qp_batch": [], "step": []}
    prm = cs.qp_params("cuda")
    for _ in range(STAGE_STEPS):
        t = DT * i
        stages["transcribe_vectors"].append(timed(lambda: step.transcribe_vectors(t, xs[0]))[1])
        qps, ms = timed(lambda: step.condensed_qp(t, xs))
        stages["condensed_qp"].append(ms)
        stages["solve_qp_batch"].append(timed(lambda: solve_qp_batch(qps, prm, ws, step.factors))[1])
        stages["step"].append(timed(advance)[1])
    for name, v in stages.items():
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        cs.phase("stage", f"{name}: median {med:.3f} ms (q1 {q1:.3f}, q3 {q3:.3f}) "
                          f"over {STAGE_STEPS} steps at B={B}")

    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        advance()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_STEPS):
            advance()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in device)
    kern_us = sum(e.time_range.elapsed_us() for e in device if KERNEL_NAME in e.name)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile_table.txt", "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    if not device:
        cs.phase("profile", "the profiler recorded no device events: device time not measured")
        return
    cs.phase("profile", f"{PROFILE_STEPS} steps: {len(device)} device events "
                        f"({len(device) / PROFILE_STEPS:.1f} a step), device time "
                        f"{dev_us / 1e3:.3f} ms ({dev_us / 1e3 / PROFILE_STEPS:.3f} ms a step), "
                        f"ADMM kernel {kern_us / 1e3:.3f} ms ({kern_us / max(dev_us, 1e-9) * 100:.1f}% "
                        f"of device time); the same steps unprofiled {wall_ms:.3f} ms, "
                        f"device busy share {dev_us / 1e3 / wall_ms * 100:.2f}%")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
