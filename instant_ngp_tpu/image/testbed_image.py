"""Image mode: fit a neural field to a 2D image.

Re-implements src/testbed_image.cu (519 LoC) semantics:
- network dims: in=2 (uv), out=3 (RGB) — network_dims_image (:31);
- training samples: 2D coords from Random/Halton/Sobol/Stratified QMC
  (:39-76, train_image :225-244), one fused jit step instead of separate
  kernel launches;
- targets: snapped-or-bilinear texture fetch; LDR-style training happens in
  sRGB space (linear_colors=false converts the linear texture per fetch,
  eval_image_kernel_and_snap :164-222);
- render: rays through a virtual camera hit the plane z=0.5; uv = plane
  hit, aspect-corrected and y-flipped (init_image_coords :77-138); network
  colors are sRGB→linear converted into the linear framebuffer
  (shade_kernel_image :140-165);
- grid auto-derivation: desired finest resolution = max(image res)/2
  (src/testbed.cu:3704-3706).

Design notes: the whole train step (QMC gen → texture gather → fwd →
bwd → optimizer) is ONE jitted function; multi-step training runs under
lax.scan so steps pipeline on device with zero host round-trips. Batches
are static-shape; the texture lives in device memory as a (H*W, 4) array and target
fetch is a gather that XLA fuses with the surrounding arithmetic.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..common import TestbedMode
from ..ops.factory import create_network_with_encoding
from ..ops.losses import create_loss
from ..ops.optimizers import create_optimizer
from ..ops.sampling import halton23, ld_samples, stratify2
from ..ops.trainer import Trainer

_SRGB_EPS = 1e-12


def _linear_to_srgb(x):
    return jnp.where(x <= 0.0031308, 12.92 * x,
                     1.055 * jnp.maximum(x, _SRGB_EPS) ** (1.0 / 2.4) - 0.055)


def _srgb_to_linear(x):
    return jnp.where(x <= 0.04045, x / 12.92,
                     ((jnp.maximum(x, 0.0) + 0.055) / 1.055) ** 2.4)


class ImageTestbed:
    """Image-mode testbed. `image` is linear float32 (H, W, C)."""

    mode = TestbedMode.Image

    def __init__(self, image: np.ndarray, network_config: Dict[str, Any],
                 seed: int = 1337, compute_dtype=jnp.bfloat16):
        image = np.asarray(image, np.float32)
        if image.ndim == 2:
            image = image[:, :, None]
        if image.shape[2] < 4:
            pad = np.ones((*image.shape[:2], 4 - image.shape[2]), np.float32)
            image = np.concatenate([image, pad], axis=-1)
        self.height, self.width = image.shape[:2]
        self.image = jnp.asarray(image[..., :4])

        self.config = network_config
        # desired finest hash level = half the larger image dimension
        desired_res = max(self.width, self.height) / 2.0
        self.model, self.resolved_config = create_network_with_encoding(
            2, 3, network_config, desired_resolution=desired_res,
            compute_dtype=compute_dtype)
        self.optimizer = create_optimizer(network_config.get("optimizer", {}))
        self.loss_fn = create_loss(network_config.get("loss", {"otype": "L2"}))
        self.trainer = Trainer(self.model, self.optimizer, self.loss_fn,
                               seed=seed)
        self.state = self.trainer.init_state()
        self.training_step = 0
        self.seed = seed
        self.loss_scalar = float("nan")

        # reference defaults (testbed.h:878-882)
        self.random_mode = "Stratified"
        self.snap_to_pixel_centers = True
        self.linear_colors = False

        self._train_n = None
        # >1: fuse K steps into one lax.scan dispatch
        self.steps_per_dispatch = 1
        self._train_fn = None
        # stochastic-corner grid encoding during training (unbiased,
        # 2^d fewer table gathers and scatter-adds). Exact d-linear
        # encode always used at render/eval time.
        self.stochastic_corners = True
        # image fitting is a high-precision regression: corner noise
        # costs ~15 dB at convergence (albert quarter-res @1000 steps:
        # 25.0 dB stochastic vs 40.6 exact; 256 stochastic + 744 exact
        # recovers 39.5 — walkthrough_out/variance_schedule_ab.json).
        # Default: cheap stochastic warmup, then exact. The schedule
        # ships in the config zoo (configs/image/base.json) so snapshots
        # and config round-trips preserve it.
        self.stochastic_corners_until = network_config.get(
            "encoding", {}).get("stochastic_corners_until", 256)

    # ------------------------------------------------------------------
    # target fetch — eval_image_kernel_and_snap (testbed_image.cu:164-222)
    # ------------------------------------------------------------------
    def _fetch_targets(self, image: jax.Array, positions: jax.Array
                       ) -> Tuple[jax.Array, jax.Array]:
        """positions (N,2) in [0,1] -> (snapped positions, (N,3) targets).

        `image` is passed explicitly (not closed over) so jit treats the
        texture as a runtime argument instead of inlining a multi-MB
        constant into the HLO (which slows compilation)."""
        w, h = self.width, self.height
        tex = image.reshape(-1, 4)

        def read(ix, iy):
            val = tex[iy * w + ix]
            rgb = val[..., :3]
            if not self.linear_colors:
                rgb = _linear_to_srgb(rgb)
            return rgb

        res = jnp.asarray([w, h], jnp.float32)
        if self.snap_to_pixel_centers:
            pos_int = jnp.floor(positions * res).astype(jnp.int32)
            snapped = (pos_int.astype(jnp.float32) + 0.5) / res
            pos_int = jnp.clip(pos_int, 0, jnp.asarray([w - 1, h - 1]))
            return snapped, read(pos_int[:, 0], pos_int[:, 1])

        pos = jnp.clip(positions * res - 0.5, 0.0, res - (1.0 + 1e-4))
        pos_int = pos.astype(jnp.int32)
        frac = pos - pos_int.astype(jnp.float32)
        idx = jnp.clip(pos_int, 0, jnp.asarray([w - 2, h - 2]))
        x0, y0 = idx[:, 0], idx[:, 1]
        wx, wy = frac[:, 0:1], frac[:, 1:2]
        val = ((1 - wx) * (1 - wy) * read(x0, y0)
               + wx * (1 - wy) * read(x0 + 1, y0)
               + (1 - wx) * wy * read(x0, y0 + 1)
               + wx * wy * read(x0 + 1, y0 + 1))
        return positions, val

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _stoch_now(self) -> bool:
        """Effective stochastic-corner flag at the current step (the
        coarse-to-fine variance schedule)."""
        if not self.stochastic_corners:
            return False
        until = getattr(self, "stochastic_corners_until", None)
        return until is None or self.training_step < until

    def _make_train_fn(self, batch_size: int, stoch: bool):
        """One fused, donated jit step (or, with steps_per_dispatch > 1,
        a lax.scan block of them — one dispatch per block)."""
        mode = self.random_mode
        seed = self.seed

        def one_step(state, image, step, key):
            enc_key = jax.random.fold_in(key, 0x5C) if stoch else None
            if mode in ("Halton", "Sobol"):
                # QMC sequences advance by batch_size per training step
                base = (step * batch_size).astype(jnp.uint32)
                idx = jnp.arange(batch_size, dtype=jnp.uint32) + base
                positions = (halton23(idx) if mode == "Halton"
                             else ld_samples(idx, seed, 2))
            else:
                positions = jax.random.uniform(key, (batch_size, 2))
                log2 = int(math.log2(batch_size))
                if (mode == "Stratified" and (1 << log2) == batch_size
                        and log2 % 2 == 0):
                    positions = stratify2(positions, log2)
            positions, targets = self._fetch_targets(image, positions)
            return self.trainer.train_step(state, positions, targets,
                                           encode_rng=enc_key)

        if self.steps_per_dispatch > 1:
            def block(state, image, step0, keys):
                steps = step0 + jnp.arange(keys.shape[0])

                def body(st, xs):
                    step, key = xs
                    return one_step(st, image, step, key)

                return jax.lax.scan(body, state, (steps, keys))

            return jax.jit(block, donate_argnums=(0,))
        return jax.jit(one_step, donate_argnums=(0,))

    def train(self, n_steps: int, batch_size: int = 1 << 18) -> float:
        """Run n_steps training steps; returns last loss."""
        remaining = n_steps
        loss = self.loss_scalar
        until = getattr(self, "stochastic_corners_until", None)
        while remaining > 0:
            n = remaining
            if (self.stochastic_corners and until is not None
                    and self.training_step < until):
                # don't cross the stochastic->exact boundary in a chunk
                n = min(n, until - self.training_step)
            loss = self._train_chunk(n, batch_size)
            remaining -= n
        return loss

    def _train_chunk(self, n_steps: int, batch_size: int) -> float:
        stoch = self._stoch_now()
        cache_key = (batch_size, min(self.steps_per_dispatch, n_steps),
                     stoch)
        if self._train_n != cache_key:
            self._train_fn = self._make_train_fn(batch_size, stoch)
            self._train_n = cache_key
        base_key = jax.random.PRNGKey(self.seed)
        loss = None
        if self.steps_per_dispatch > 1:
            done = 0
            while done < n_steps:
                k = min(self.steps_per_dispatch, n_steps - done)
                keys = jnp.stack([
                    jax.random.fold_in(base_key, self.training_step + j)
                    for j in range(k)])
                self.state, losses = self._train_fn(
                    self.state, self.image,
                    jnp.asarray(self.training_step), keys)
                self.training_step += k
                done += k
                loss = losses[-1]
        else:
            for _ in range(n_steps):
                key = jax.random.fold_in(base_key, self.training_step)
                self.state, loss = self._train_fn(
                    self.state, self.image, jnp.asarray(self.training_step),
                    key)
                self.training_step += 1
        self.loss_scalar = float(loss)
        return self.loss_scalar

    # ------------------------------------------------------------------
    # rendering — init_image_coords + shade_kernel_image
    # ------------------------------------------------------------------
    def render(self, width: int, height: int,
               params=None) -> np.ndarray:
        """Top-down render of the fitted image at the given resolution.

        Equivalent to the reference's default camera looking straight at
        the z=0.5 image plane: uv spans the unit square (aspect-corrected),
        exactly the identity view used by compute_image_mse."""
        if params is None:
            params = self.trainer.inference_params(self.state)
        out = self._render_jit(params, width, height)
        return np.asarray(out)

    @partial(jax.jit, static_argnums=(0, 2, 3))
    def _render_jit(self, params, width: int, height: int) -> jax.Array:
        u = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
        v = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
        uv = jnp.stack(jnp.meshgrid(u, v, indexing="xy"), axis=-1)
        uv = uv.reshape(-1, 2)
        colors = self.model.apply(params, uv)
        if not self.linear_colors:
            colors = _srgb_to_linear(colors)
        rgba = jnp.concatenate(
            [colors, jnp.ones((colors.shape[0], 1), colors.dtype)], axis=-1)
        return rgba.reshape(height, width, 4)

    # ------------------------------------------------------------------
    def compute_mse(self, quantize: bool = False) -> float:
        """MSE of a full-res render vs the training image in sRGB space
        (compute_image_mse, testbed.h:649 — it compares in the training
        color space with optional byte quantization)."""
        params = self.trainer.inference_params(self.state)
        render = self._render_jit(params, self.width, self.height)[..., :3]
        target = self.image[..., :3]
        if not self.linear_colors:
            render = _linear_to_srgb(jnp.maximum(render, 0.0))
            target = _linear_to_srgb(target)
        if quantize:
            render = jnp.floor(jnp.clip(render, 0, 1) * 255.0 + 0.5) / 255.0
            target = jnp.floor(jnp.clip(target, 0, 1) * 255.0 + 0.5) / 255.0
        return float(jnp.mean((render - target) ** 2))

    def psnr(self) -> float:
        return -10.0 * math.log10(max(self.compute_mse(), 1e-20))

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------
    def save_snapshot(self, path: str) -> None:
        from ..data.snapshot import save_snapshot

        save_snapshot(path, {
            "mode": self.mode.value,
            "config": self.config,
            "grid_layout": getattr(self.model.encoding, "layout", "planar"),
            "trainer": self.state,
            "training_step": self.training_step,
            "image_resolution": [self.width, self.height],
        })

    def load_snapshot_state(self, snapshot: Dict[str, Any]) -> None:
        state = jax.tree_util.tree_map(jnp.asarray, snapshot["trainer"])
        enc = self.model.encoding
        if hasattr(enc, "convert_state_layout"):
            state = enc.convert_state_layout(
                state, snapshot.get("grid_layout", "planar"))
        self.state = state
        self.training_step = int(snapshot.get("training_step", 0))
