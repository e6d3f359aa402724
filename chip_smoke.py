#!/usr/bin/env python3
"""On-card smoke test of the main training and rendering path.

    python chip_smoke.py          # one GPU: every phase below but `four`
    python chip_smoke.py --four   # four GPUs: the data-parallel phase only

Phases (one card):
  device      JAX runs on a GPU; prints device_kind and the card's name
              and power limit as nvidia-smi reports them.
  parity      exact hash-grid encode of configs/nerf/base.json at N = 2^18
              (row path and flat path: forward, table gradient, input
              gradient) and both NeRF MLPs in bf16, each against the plain
              float32 reference under matmul precision "highest".
  train       the procedural sphere scene (seed 0, 64 views at 400^2)
              written to disk and trained 512 steps through Testbed with
              the shipped base.json at batch 2^18; loss falls, the
              measured batch is within 2x of 2^18, and the mean PSNR of
              training views 0/16/32/48 (spp 2, black background) >= 27 dB.
  render      Testbed.render(1920, 1080, spp=1) of the trained model.
  image       64 steps of image mode (configs/image/base.json) on a 1024^2
              view of the scene at batch 2^18, stochastic then exact.
  stochastic  mean of the default stochastic training encode over 1024
              keys against the exact encode, on the trained table (one
              key's estimate is ~75% off in relative L2 on this table,
              so fewer keys cannot meet a 5% bound).

Phase `four` (--four): one step of make_sharded_train_step on a 1-D
4-card `data` mesh against the same 4 key shards stepped one by one on
card 0 (the Adam first moment after one step is linear in the averaged
gradient, so the shards' moments average to the sharded one), then 32
host-loop steps of NerfTestbed on the mesh.

Every phase prints what it measured. A phase that fails prints its
traceback; later phases still run unless they need its result. The last
line, {"ok": true, "device": {...}}, is printed only when every phase
passed; otherwise the exit code is 1.
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# limits, each with its reason
ENCODE_FWD_MAX_REL = 1e-5    # only the summation order differs
ENCODE_TABLE_GRAD_L2 = 1e-5  # atomic scatter-adds sum in run-varying order
ENCODE_INPUT_GRAD_L2 = 1e-4  # sums over levels x corners x features
STOCHASTIC_MEAN_L2 = 5e-2    # 1024-key mean of an unbiased estimator
MLP_BF16_L2 = 2e-2           # bf16 operands, f32 accumulation
PSNR_MIN_DB = 27.0           # 512 steps; margin for TF32 and atomics order
EVAL_VIEWS = (0, 16, 32, 48)


def max_rel(a, b):
    """max |a - b| / max |b|."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def rel_l2(a, b):
    """||a - b|| / ||b|| over all elements."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def require(cond, msg):
    """A phase's check; unlike `assert` it also holds under python -O."""
    if not cond:
        raise AssertionError(msg)


def check(name, err, limit):
    ok = err <= limit
    print(f"  {name}: {err:.3e} (limit {limit:.0e}) {'ok' if ok else 'FAIL'}",
          flush=True)
    require(ok, f"{name} {err:.3e} > {limit:.0e}")


class CompileClock:
    """Context manager summing JAX's own compile-phase durations (trace,
    lowering, backend compile) and counting backend compiles."""

    def __init__(self):
        import jax

        self.active = False
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, secs, **kw):
        if self.active and name.startswith("/jax/core/compile/"):
            self.seconds += secs
            self.compiles += name.endswith("backend_compile_duration")

    def __enter__(self):
        self.seconds, self.compiles, self.active = 0.0, 0, True
        return self

    def __exit__(self, *exc):
        self.active = False


def nerf_config():
    from instant_ngp_tpu.config import find_network_config, load_network_config

    return load_network_config(find_network_config("base.json", mode="nerf"))


def nerf_grid(cfg):
    """The position encoding exactly as NerfNetwork builds it (aabb 1)."""
    from instant_ngp_tpu.ops.encodings import create_encoding
    from instant_ngp_tpu.ops.factory import derive_grid_config

    return create_encoding(3, derive_grid_config(cfg["encoding"], 3, 2048.0,
                                                 1.0))


def phase_device(n_cards):
    import jax

    devs = jax.devices()
    require(jax.default_backend() == "gpu",
            f"JAX backend is {jax.default_backend()!r}, not 'gpu'")
    require(all(d.platform == "gpu" for d in devs), devs)
    require(len(devs) >= n_cards, f"need {n_cards} GPUs, have {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"  jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    for line in smi.splitlines():
        print(f"  nvidia-smi: {line.strip()}")


def phase_parity(n=1 << 18):
    import jax
    import jax.numpy as jnp

    from instant_ngp_tpu.ops.mlp import MLP

    cfg = nerf_config()
    flat = nerf_grid(cfg)                   # the default (flat) path
    require(flat.layout == "planar", flat.layout)
    row = dataclasses.replace(flat, row_gather=True)
    ref = dataclasses.replace(flat)
    ref.fused = False                       # per-level reference loop
    kx, kp, kg = jax.random.split(jax.random.PRNGKey(0), 3)
    x = jax.random.uniform(kx, (n, 3))
    params = flat.init(kp)
    g_out = jax.random.normal(kg, (n, flat.n_output_dims))
    print(f"  encode: L={flat.n_levels} F={flat.n_features_per_level} "
          f"T=2^{flat.log2_hashmap_size} params={flat.n_params} N={n}")

    def value_and_grads(enc):
        def loss(p, x, g):
            return jnp.sum(enc.apply(p, x) * g)

        def f(p, x, g):
            dp, dx = jax.grad(loss, argnums=(0, 1))(p, x, g)
            return enc.apply(p, x), dp, dx
        return jax.jit(f)

    with jax.default_matmul_precision("highest"):
        r_out, r_dp, r_dx = value_and_grads(ref)(params, x, g_out)
    results = {"flat": value_and_grads(flat)(params, x, g_out)}
    out, dp, dx = value_and_grads(row)(
        row.convert_layout(params, flat.layout), x, g_out)
    results["row"] = (out, flat.convert_layout(dp, row.layout), dx)
    for name, (out, dp, dx) in results.items():
        check(f"{name} forward max rel", max_rel(out, r_out),
              ENCODE_FWD_MAX_REL)
        check(f"{name} table grad rel L2", rel_l2(dp, r_dp),
              ENCODE_TABLE_GRAD_L2)
        check(f"{name} input grad rel L2", rel_l2(dx, r_dx),
              ENCODE_INPUT_GRAD_L2)

    for name, n_in, n_out, net in (
            ("density MLP", flat.n_output_dims, 16, cfg["network"]),
            ("rgb MLP", 32, 3, cfg["rgb_network"])):
        mlp = MLP.from_config(n_in, n_out, net, compute_dtype=jnp.bfloat16)
        mlp32 = MLP.from_config(n_in, n_out, net, compute_dtype=jnp.float32)
        w = mlp.init(jax.random.PRNGKey(n_out))
        h = jax.random.normal(jax.random.PRNGKey(n_in), (n, n_in))
        with jax.default_matmul_precision("highest"):
            want = jax.jit(mlp32.apply)(w, h)
        check(f"{name} bf16 rel L2", rel_l2(jax.jit(mlp.apply)(w, h), want),
              MLP_BF16_L2)


def phase_train(workdir, out, n_cams=64, size=400, steps=512,
                batch=1 << 18, psnr_min=PSNR_MIN_DB, eval_views=EVAL_VIEWS):
    """Trains through Testbed; out["tb"] holds it for the later phases."""
    import jax
    import numpy as np

    from instant_ngp_tpu.data.procedural import write_scene
    from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed
    from instant_ngp_tpu.testbed import Testbed

    t0 = time.perf_counter()
    scene = os.path.dirname(write_scene(os.path.join(workdir, "sphere"),
                                        n_cams=n_cams, size=size, seed=0))
    tb = Testbed()
    tb.load_training_data(scene)
    tb.reload_network_from_file("base.json")
    nerf = tb.nerf
    out["tb"] = tb
    print(f"  scene: {n_cams} views at {size}^2 written and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    nerf.target_batch_size = batch
    require(nerf.steps_per_dispatch == 16 and nerf.stochastic_corners,
            "not the library's default dispatch and encode")

    clock = CompileClock()
    # first 32 steps: every scanned-block shape compiles here
    t0 = time.perf_counter()
    with clock:
        loss_first = tb.train(16)
        tb.train(16)
    first32_cold, compile_cold = time.perf_counter() - t0, clock.seconds
    tb.train(steps // 2 - 32)
    window = steps - steps // 2
    t0 = time.perf_counter()
    with clock:            # the adaptive ray batch may change bucket here
        loss_last = tb.train(window)
    dt = time.perf_counter() - t0
    measured = nerf.measured_batch_size
    steps_per_s = window / (dt - clock.seconds)
    print(f"  steps {steps}: loss {loss_first:.5f} (step 16) -> "
          f"{loss_last:.5f}; measured batch {measured}, rays/batch "
          f"{nerf.rays_per_batch}, n_march {nerf.n_march}")
    print(f"  window of {window} steps: {dt:.2f} s, of which "
          f"{clock.seconds:.2f} s in {clock.compiles} compiles; without "
          f"them {steps_per_s:.3f} steps/s, "
          f"{steps_per_s * measured:.4g} samples/s, "
          f"{1e3 / steps_per_s:.2f} ms/step")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak device memory: "
          f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB")

    # the same first 32 steps in a fresh testbed: its programs come from
    # the persistent compilation cache
    fresh = NerfTestbed(nerf.dataset, nerf.config)
    fresh.target_batch_size = batch
    t0 = time.perf_counter()
    with clock:
        fresh.train(16)
        fresh.train(16)
    first32_warm = time.perf_counter() - t0
    del fresh
    print(f"  first 32 steps: cold {first32_cold:.1f} s (compile "
          f"{compile_cold:.1f} s), warm from the persistent cache "
          f"{first32_warm:.1f} s (compile {clock.seconds:.1f} s)")

    require(np.isfinite(loss_last), "loss is not finite")
    require(loss_last < loss_first, "loss did not fall")
    require(batch // 2 <= measured <= batch * 2,
            f"measured batch {measured} not within 2x of {batch}")
    psnrs = [nerf.eval_psnr(v, spp=2) for v in eval_views]
    print("  PSNR " + ", ".join(f"view {v}: {p:.2f} dB"
                                for v, p in zip(eval_views, psnrs)))
    check("mean PSNR shortfall (dB)", psnr_min - float(np.mean(psnrs)), 0.0)


def phase_render(tb, width=1920, height=1080):
    import numpy as np

    tb.render(width, height, spp=1)           # compile
    t0 = time.perf_counter()
    img = tb.render(width, height, spp=1)
    ms = (time.perf_counter() - t0) * 1e3
    print(f"  {width}x{height} spp 1: {ms:.1f} ms/frame (warm); "
          f"alpha max {img[..., 3].max():.3f}, rgb std "
          f"{img[..., :3].std():.4f}")
    require(img.shape == (height, width, 4), img.shape)
    require(np.isfinite(img).all(), "render is not finite")
    require(img[..., 3].max() > 0.5 and img[..., :3].std() > 1e-3,
            "render is blank")


def phase_image(size=1024, batch=1 << 18, steps=64):
    import numpy as np

    from instant_ngp_tpu.config import find_network_config, load_network_config
    from instant_ngp_tpu.data.procedural import make_image
    from instant_ngp_tpu.image import ImageTestbed

    cfg = load_network_config(find_network_config("base.json", mode="image"))
    tb = ImageTestbed(make_image(size, seed=0), cfg)
    quarter = steps // 4
    tb.stochastic_corners_until = steps // 2
    loss_first = tb.train(1, batch_size=batch)
    rates = {}
    for phase in ("stochastic", "exact"):
        tb.train(quarter - (1 if phase == "stochastic" else 0),
                 batch_size=batch)                     # compile + warm
        t0 = time.perf_counter()
        loss_last = tb.train(quarter, batch_size=batch)
        rates[phase] = quarter * batch / (time.perf_counter() - t0)
    print(f"  {size}^2 image, {steps} steps at batch {batch}: loss "
          f"{loss_first:.5f} -> {loss_last:.5f}; samples/s stochastic "
          f"{rates['stochastic']:.4g}, exact {rates['exact']:.4g}")
    require(np.isfinite(loss_last) and loss_last < loss_first,
            "image loss did not fall")


def phase_stochastic(tb, n=1 << 18, n_keys=1024):
    import jax
    import jax.numpy as jnp

    nerf = tb.nerf
    enc = nerf.model.pos_encoding
    params = nerf.inference_params()["pos_encoding"]
    x = jax.random.uniform(jax.random.PRNGKey(7), (n, 3))
    exact = jax.jit(enc.apply)(params, x)
    stoch = jax.jit(lambda p, x, k: enc.apply(p, x, rng=k))
    acc = jnp.zeros_like(exact)
    for i in range(n_keys):
        acc = acc + stoch(params, x, jax.random.PRNGKey(1000 + i))
    print(f"  exact_axes={enc.stochastic_exact_axes} "
          f"stochastic_bwd={enc.stochastic_bwd}, trained table, N={n}")
    check(f"{n_keys}-key mean rel L2", rel_l2(acc / n_keys, exact),
          STOCHASTIC_MEAN_L2)


def phase_four(n_cams=64, size=400, batch=1 << 18, loop_steps=32):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from instant_ngp_tpu.data.procedural import make_scene
    from instant_ngp_tpu.nerf.occupancy import init_bitfield
    from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed
    from instant_ngp_tpu.parallel import data_parallel_mesh, replicate

    n_dev = 4
    mesh = data_parallel_mesh(jax.devices()[:n_dev])
    ds = make_scene(n_cams, size, seed=0)
    cfg = nerf_config()
    tb = NerfTestbed(ds, cfg, mesh=mesh)
    tb.target_batch_size = batch
    one = NerfTestbed(ds, cfg)                 # card 0, one shard per call
    one.target_batch_size = batch // n_dev
    n_rays = tb._bucket(tb.rays_per_batch // n_dev)
    max_k = tb._bucket_k(n_rays * n_dev)
    sharded = tb._get_train_fn(n_rays, max_k)
    single = one._get_train_fn(n_rays, max_k)
    print(f"  mesh {dict(mesh.shape)}: {n_rays} rays and "
          f"{batch // n_dev} samples per card")

    state0 = jax.tree_util.tree_map(np.asarray, tb.state)
    bitfield = jnp.full_like(init_bitfield(), 255)   # every cell occupied
    keys = jax.random.split(jax.random.PRNGKey(0), n_dev)
    args = (None, None, None, None, None)            # cam, error map, ...
    new, stats = sharded(
        replicate(mesh, jax.tree_util.tree_map(jnp.asarray, state0)),
        replicate(mesh, tb.data), replicate(mesh, bitfield),
        replicate(mesh, jnp.zeros(())),
        jax.device_put(keys, NamedSharding(mesh, P("data"))), *args)
    m_sharded = jax.tree_util.tree_map(np.asarray, new["opt"]["m"])
    moments, losses = [], []
    for c in range(n_dev):
        s1, st1 = single(jax.tree_util.tree_map(jnp.asarray, state0),
                         one.data, bitfield, jnp.zeros(()), keys[c], *args)
        moments.append(jax.tree_util.tree_map(np.asarray, s1["opt"]["m"]))
        losses.append(float(st1["loss"]))
    m_ref = jax.tree_util.tree_map(lambda *m: sum(m) / n_dev, *moments)
    flat = lambda t: np.concatenate(
        [np.ravel(v) for v in jax.tree_util.tree_leaves(t)])
    print(f"  loss sharded {float(stats['loss']):.6f}, shards one by one "
          f"{np.mean(losses):.6f}; measured batch "
          f"{int(stats['measured_batch_size'])}")
    check("gradient-averaged update (Adam m) rel L2",
          rel_l2(flat(m_sharded), flat(m_ref)), 1e-5)

    losses = []
    t0 = time.perf_counter()
    for _ in range(loop_steps // 4):
        losses.append(tb.train(4))
    print(f"  host loop on the mesh: {loop_steps} steps in "
          f"{time.perf_counter() - t0:.1f} s (incl. compile), loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}, measured batch "
          f"{tb.measured_batch_size}")
    require(np.isfinite(losses).all()
            and np.mean(losses[-2:]) < np.mean(losses[:2]),
            "mesh loss did not fall")


def run_phase(name, fn, *args, **kw):
    print(f"[{name}]", flush=True)
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kw)
    except Exception:
        traceback.print_exc(file=sys.stdout)
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
              flush=True)
        return False, None
    print(f"[{name}] passed in {time.perf_counter() - t0:.1f} s", flush=True)
    return True, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card data-parallel phase")
    args = ap.parse_args()
    n_cards = 4 if args.four else 1

    ok, _ = run_phase("device", phase_device, n_cards)
    if not ok:
        sys.exit(1)
    results = []
    if args.four:
        results.append(run_phase("four", phase_four)[0])
    else:
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            results.append(run_phase("parity", phase_parity)[0])
            out = {}
            results.append(run_phase("train", phase_train, workdir, out)[0])
            results.append(run_phase("image", phase_image)[0])
            if "tb" in out:
                results.append(run_phase("render", phase_render,
                                         out["tb"])[0])
                results.append(run_phase("stochastic", phase_stochastic,
                                         out["tb"])[0])
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    if not all(results):
        print("FAILED", flush=True)
        sys.exit(1)
    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))


if __name__ == "__main__":
    main()
