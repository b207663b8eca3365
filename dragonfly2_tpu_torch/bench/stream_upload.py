"""How the streaming trainer's step inputs reach the card, timed.

Trains ``StreamingTrainer`` at BASELINE configs[4]'s full width
(``StreamingConfig()`` and ``MLPConfig()``: batch 4,096,
32→256→256→128→1, bf16 compute) on rows drawn from the lifecycle drill's
seeded ground truth, once per upload mode and in a fresh trainer each
time, in the order given (by default each mode twice, the second pass in
reverse order):

- ``staged``: the trainer as it is; the four inputs packed into one of
  two pinned staging buffers and moved in one copy that does not wait;
- ``per_array``: each of the four inputs pinned anew (``pin_memory()``)
  and copied without waiting;
- ``pageable``: each of the four inputs copied from pageable memory
  (``.to(device)``).

Every run takes the same batches.  For each run prints one JSON line:
per-step host ms (p50, p90) over the timed steps (no sync inside the
window), the window's synced mean and records/s, and, from
``torch.profiler`` over 16 more steps, the host self time a step of
``aten::copy_`` and of all operators, and the device's idle share.  A
last line says whether every run ended with the same parameters (the
modes move the same values).

    python -m dragonfly2_tpu_torch.bench.stream_upload [--steps 128] [--modes ...]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..models.mlp import MLPConfig
from ..sim.lifecycle import LifecycleDrillConfig, _World
from ..trainer.streaming import StreamingConfig, StreamingTrainer
from .k1_stamps import smi

WARM_STEPS = 16
PROFILED_STEPS = 16


class _PerArray(StreamingTrainer):
    def _stage(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
                .pin_memory().to(self.device, non_blocking=True) for a in arrays]


class _Pageable(StreamingTrainer):
    def _stage(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)
                for a in arrays]


MODES = {"staged": StreamingTrainer, "per_array": _PerArray, "pageable": _Pageable}


def run_mode(mode, batches, timed, seed):
    trainer = MODES[mode](StreamingConfig(seed=seed), MLPConfig(), device="cuda")
    it = iter(batches)

    def one_step():
        trainer.feed(next(it))
        trainer.run(max_steps=1, idle_timeout=0)

    for _ in range(WARM_STEPS):
        one_step()
    torch.cuda.synchronize()
    host_ms = []
    t0 = time.perf_counter()
    for _ in range(timed):
        t1 = time.perf_counter()
        one_step()
        host_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    copy_ms = host_ops_ms = device_ms = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev_us = getattr(ev, "self_device_time_total", None)
            device_ms += (ev.self_cuda_time_total if dev_us is None else dev_us) / 1e3
            continue
        host_ops_ms += ev.self_cpu_time_total / 1e3
        if ev.key == "aten::copy_":
            copy_ms += ev.self_cpu_time_total / 1e3
    bs = trainer.config.batch_size
    params = [p.detach().cpu() for p in trainer.model.parameters()]
    return {
        "mode": mode, "timed_steps": timed, "batch": bs,
        "step_ms_p50": float(np.median(host_ms)),
        "step_ms_p90": float(np.percentile(host_ms, 90)),
        "window_mean_ms": window_s * 1e3 / timed, "records_per_s": bs * timed / window_s,
        "profiled_wall_ms_per_step": wall_ms,
        "copy_host_ms_per_step": copy_ms / PROFILED_STEPS,
        "host_ops_ms_per_step": host_ops_ms / PROFILED_STEPS,
        "device_idle_share": 1.0 - device_ms / PROFILED_STEPS / wall_ms,
    }, params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=128, help="timed steps a run")
    ap.add_argument("--modes", default="staged,per_array,pageable,pageable,per_array,staged")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_upload: no CUDA device")
    modes = args.modes.split(",")
    unknown = set(modes) - set(MODES)
    if unknown:
        raise SystemExit(f"stream_upload: unknown modes {sorted(unknown)}")
    print(json.dumps({"card": smi("name,power.limit")}), flush=True)
    bs = StreamingConfig().batch_size
    n = WARM_STEPS + args.steps + PROFILED_STEPS
    rows = _World(LifecycleDrillConfig(seed=args.seed)).record_rows(n * bs)
    batches = [rows[i * bs:(i + 1) * bs] for i in range(n)]
    finals = []
    for mode in modes:
        out, params = run_mode(mode, batches, args.steps, args.seed)
        finals.append(params)
        print(json.dumps(out), flush=True)
    same = all(all(torch.equal(a, b) for a, b in zip(finals[0], f)) for f in finals[1:])
    print(json.dumps({"same_parameters_in_every_run": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
