#!/usr/bin/env python3
"""Time one NeRF training step of configs/nerf/base.json per hash-grid
encode path, on the procedural sphere scene (64 views at 400^2).

Variants, each in its own NerfTestbed with the same pinned ray batch
(the bucket the adaptive controller reaches on this scene), 16-step
scanned dispatch, batch 2^18:

  row          exact encode, row gather + one-hot row scatter-add
  flat         exact encode, one gather per feature + element scatter-add
  row-stoch    stochastic encode (base.json: exact_axes 1, stochastic_bwd)
  flat-stoch   the same on the flat layout

Each variant compiles and trains past step 128 (where the error-map
importance sampling starts and one more program compiles), then the
variants are timed in turns (forward then reverse order, `--rounds`
times); the script prints the median
ms/step per variant and the card's name and power limit. `--trace DIR`
also records one 16-step block of each variant named in `--trace-variants`
with jax.profiler and prints the device time per XLA op. It refuses to
run without a GPU.

    python scripts/encode_paths.py [--rounds 2] [--trace chiprun_out/trace]
"""

import argparse
import dataclasses
import glob
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from instant_ngp_tpu.config import find_network_config, load_network_config  # noqa: E402
from instant_ngp_tpu.data.procedural import make_scene  # noqa: E402
from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed  # noqa: E402

VARIANTS = {  # name: (flat layout, stochastic)
    "row": (False, False),
    "flat": (True, False),
    "row-stoch": (False, True),
    "flat-stoch": (True, True),
}


def make_testbed(name, ds, cfg, rays):
    flat, stoch = VARIANTS[name]
    tb = NerfTestbed(ds, cfg)
    enc = tb.model.pos_encoding
    new = dataclasses.replace(enc, row_gather=not flat, packed=False)
    tb.state = new.convert_state_layout(tb.state, enc.layout)
    tb.model.pos_encoding = new
    tb.stochastic_corners = stoch
    tb.rays_per_batch = rays
    tb.adapt_ray_batch = False
    tb.warmup_full_grid_preps = 0      # every block is the 16-step 'lead'
    return tb


def summarize_trace(logdir, top=25):
    """Device busy share and the top XLA ops by device time."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    prof = ProfileData.from_file(path)
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if ln.name == "XLA Ops"] or \
            [ln for ln in plane.lines if "Stream" in ln.name]
        print(f"    {plane.name} lines: {[ln.name for ln in plane.lines]}")
        for line in lines:
            evs = list(line.events)
            if not evs:
                continue
            spans = sorted((e.start_ns, e.end_ns) for e in evs)
            busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
            for s, e in spans[1:]:
                if s > cur_e:
                    busy += cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += cur_e - cur_s
            window = spans[-1][1] - spans[0][0]
            tot = {}
            for e in evs:
                tot[e.name] = tot.get(e.name, 0) + e.duration_ns
            print(f"    {plane.name} {line.name}: {len(evs)} ops, busy "
                  f"{busy / 1e6:.1f} of {window / 1e6:.1f} ms "
                  f"({100 * busy / max(window, 1):.1f}%)")
            for nm, ns in sorted(tot.items(), key=lambda kv: -kv[1])[:top]:
                print(f"      {ns / 1e6:9.2f} ms  {nm[:110]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--views", type=int, default=64)
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--batch", type=int, default=1 << 18)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--trace-variants", nargs="*",
                    default=["row-stoch", "flat-stoch", "flat"])
    args = ap.parse_args()

    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {jax.devices()[0].device_kind}; nvidia-smi: {smi}",
          flush=True)
    ds = make_scene(args.views, args.size, seed=0)
    cfg = load_network_config(find_network_config("base.json", mode="nerf"))

    # the adaptive controller's bucket on this scene, from a default run
    probe = NerfTestbed(ds, cfg)
    probe.target_batch_size = args.batch
    probe.train(96)
    rays = probe._bucket(probe.rays_per_batch)
    print(f"adaptive rays/batch after 96 steps: {probe.rays_per_batch} -> "
          f"pinned bucket {rays}; measured batch "
          f"{probe.measured_batch_size}", flush=True)
    del probe

    tbs = {}
    for name in args.variants:
        tbs[name] = make_testbed(name, ds, cfg, rays)
        tbs[name].target_batch_size = args.batch
        t0 = time.perf_counter()
        tbs[name].train(144)
        print(f"{name}: compiled + 144 steps in "
              f"{time.perf_counter() - t0:.1f} s, measured batch "
              f"{tbs[name].measured_batch_size}", flush=True)

    times = {n: [] for n in args.variants}
    order = list(args.variants)
    for r in range(args.rounds):
        for name in order + order[::-1]:
            t0 = time.perf_counter()
            tbs[name].train(args.steps)
            times[name].append(
                (time.perf_counter() - t0) * 1e3 / args.steps)
    print(f"ms/step (median of {2 * args.rounds} windows of "
          f"{args.steps} steps, {rays} rays, batch {args.batch}):")
    for name in args.variants:
        t = times[name]
        print(f"  {name:12s} {np.median(t):8.2f}  "
              f"[{', '.join(f'{x:.2f}' for x in t)}]  loss "
              f"{tbs[name].loss_scalar:.5f}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak device memory: "
          f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB", flush=True)

    if args.trace:
        for name in args.trace_variants:
            if name not in tbs:
                continue
            logdir = os.path.join(args.trace, name)
            with jax.profiler.trace(logdir):
                tbs[name].train(16)
            print(f"  trace {name} (one 16-step block):", flush=True)
            summarize_trace(logdir)


if __name__ == "__main__":
    main()
