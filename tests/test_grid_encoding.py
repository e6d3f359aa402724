import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instant_ngp_tpu.ops.grid_encoding import GridEncoding, grid_resolution, grid_scale


def small_hash(n_dims=3, **kw):
    defaults = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=8,
                    base_resolution=4, per_level_scale=2.0, grid_type="Hash")
    defaults.update(kw)
    return GridEncoding(n_dims, **defaults)


def test_level_layout():
    enc = small_hash()
    # level 0: scale 3, res 4 -> 64 dense entries (< 256 hashmap) -> dense
    assert enc._resolutions[0] == 4 and not enc._hashed[0]
    assert enc._sizes[0] == 64
    # level 3: scale 31, res 32 -> 32768 > 256 -> hashed, capped
    assert enc._hashed[3] and enc._sizes[3] == 256
    assert enc.n_params == enc._sizes.sum() * 2
    assert enc.n_output_dims == 8


def test_dense_trilinear_exact():
    """With a dense grid whose features are a linear ramp of the vertex
    coordinates, d-linear interpolation must reproduce the ramp exactly."""
    enc = GridEncoding(3, n_levels=1, n_features_per_level=1,
                       log2_hashmap_size=16, base_resolution=8,
                       per_level_scale=2.0, grid_type="Dense")
    res = int(enc._resolutions[0])
    scale = float(enc._scales[0])
    coords = np.stack(np.meshgrid(*([np.arange(res)] * 3), indexing="ij"),
                      -1).reshape(-1, 3)
    # vertex at integer grid position g corresponds to... linear fn of g
    table = (coords @ np.array([1.0, 10.0, 100.0]))[:, None].astype(np.float32)
    # dense index = x + y*res + z*res^2 -> our coords must match that layout
    flat = np.zeros((enc.n_params, 1), np.float32)
    idx = coords[:, 0] + coords[:, 1] * res + coords[:, 2] * res * res
    flat[idx] = table
    params = jnp.asarray(flat.ravel())

    rng = np.random.default_rng(0)
    # keep pos = x*scale + 0.5 at least one cell away from the clamped
    # boundary so corner indices never clamp
    x = rng.uniform(0.1, 0.85, (64, 3)).astype(np.float32)
    out = np.asarray(enc.apply(params, jnp.asarray(x)))
    # pos = x*scale + 0.5 -> expected value = linear fn of pos
    pos = x * scale + 0.5
    expected = pos @ np.array([1.0, 10.0, 100.0])
    np.testing.assert_allclose(out[:, 0], expected, rtol=1e-4)


def test_hash_encoding_gradient_matches_numeric():
    enc = small_hash()
    key = jax.random.PRNGKey(0)
    params = enc.init(key)
    x = jax.random.uniform(jax.random.PRNGKey(1), (16, 3))

    def f(p):
        return jnp.sum(enc.apply(p, x) ** 2)

    g = jax.grad(f)(params)
    assert g.shape == params.shape
    # numeric check on a few touched entries
    touched = np.nonzero(np.asarray(g))[0][:5]
    eps = 1e-4
    for i in touched:
        pp = params.at[i].add(eps)
        pm = params.at[i].add(-eps)
        num = (f(pp) - f(pm)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(g)[i], num, rtol=1e-2, atol=1e-6)


def test_max_level_masking():
    enc = small_hash()
    params = enc.init(jax.random.PRNGKey(0)) + 1.0  # ensure nonzero feats
    x = jnp.full((4, 3), 0.3)
    out = np.asarray(enc.apply(params, x, max_level=1))
    F = enc.n_features_per_level
    assert np.abs(out[:, :2 * F]).min() > 0
    np.testing.assert_array_equal(out[:, 2 * F:], 0.0)


def test_tiled_wraps():
    enc = GridEncoding(2, n_levels=1, n_features_per_level=1,
                       log2_hashmap_size=20, base_resolution=8,
                       grid_type="Tiled")
    params = enc.init(jax.random.PRNGKey(2))
    # x slightly outside [0,1] wraps instead of reading out of bounds
    out = enc.apply(params, jnp.array([[1.05, -0.05]]))
    assert np.isfinite(np.asarray(out)).all()


def test_2d_grid_image_config():
    """configs/image/base.json encoding."""
    enc = GridEncoding.from_config(2, {
        "otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
        "log2_hashmap_size": 15, "base_resolution": 16})
    assert enc.n_output_dims == 32
    params = enc.init(jax.random.PRNGKey(0))
    out = enc.apply(params, jax.random.uniform(jax.random.PRNGKey(1), (8, 2)))
    assert out.shape == (8, 32)


def test_desired_resolution_derivation():
    """Reference auto-derivation (src/testbed.cu:3679-3723): per-level scale
    from desired finest resolution."""
    enc = GridEncoding.from_config(3, {
        "otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
        "log2_hashmap_size": 19, "base_resolution": 16,
        "desired_resolution": 2048})
    b = enc.per_level_scale
    np.testing.assert_allclose(16 * b ** 15, 2048, rtol=1e-6)


def test_fused_matches_per_level_loop():
    import jax, jax.numpy as jnp
    from instant_ngp_tpu.ops.grid_encoding import GridEncoding

    for gtype in ("Hash", "Dense", "Tiled"):
        # packed=False: the fused path must match the per-level loop to
        # fp32 precision
        enc = GridEncoding(n_dims=3, n_levels=6, n_features_per_level=2,
                           log2_hashmap_size=11, base_resolution=4,
                           per_level_scale=1.6, grid_type=gtype,
                           packed=False)
        params = enc.init(jax.random.PRNGKey(0))
        x = jax.random.uniform(jax.random.PRNGKey(1), (257, 3))
        fused = enc.apply(params, x)
        enc.fused = False
        loop = enc.apply(params, x)
        np.testing.assert_allclose(np.asarray(fused), np.asarray(loop),
                                   rtol=1e-5, atol=1e-7)
        # gradients agree too (scatter-add path)
        enc.fused = True
        g1 = jax.grad(lambda p: jnp.sum(enc.apply(p, x) ** 2))(params)
        enc.fused = False
        g2 = jax.grad(lambda p: jnp.sum(enc.apply(p, x) ** 2))(params)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                                   rtol=1e-4, atol=1e-7)

        # packed=True (bf16 feature-pair path): values
        # within bf16 quantization of the exact path, table gradient
        # near-exact (fp32 scatter), input gradients within bf16 error
        encp = GridEncoding(n_dims=3, n_levels=6, n_features_per_level=2,
                            log2_hashmap_size=11, base_resolution=4,
                            per_level_scale=1.6, grid_type=gtype,
                            packed=True)
        assert encp.packed and encp.layout == enc.layout == "planar"
        pf = encp.apply(params, x)
        scale = float(np.abs(np.asarray(loop)).max())
        np.testing.assert_allclose(np.asarray(pf), np.asarray(loop),
                                   atol=scale * 8e-3)
        g3 = jax.grad(lambda p: jnp.sum(encp.apply(p, x) ** 2))(params)
        gs = float(np.abs(np.asarray(g2)).max())
        np.testing.assert_allclose(np.asarray(g3), np.asarray(g2),
                                   atol=gs * 1e-2)


def test_fused_max_level_masking():
    import jax, jax.numpy as jnp
    from instant_ngp_tpu.ops.grid_encoding import GridEncoding

    enc = GridEncoding(n_dims=2, n_levels=4, n_features_per_level=2,
                       log2_hashmap_size=10, base_resolution=4)
    params = enc.init(jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (64, 2))
    out = np.asarray(enc.apply(params, x, max_level=1))
    assert np.abs(out[:, :4]).max() > 0
    np.testing.assert_allclose(out[:, 4:], 0.0)


def test_stochastic_corner_unbiased_forward_and_grad():
    """The stochastic 1-of-2^d corner estimator must match the exact
    d-linear encode (and its table gradient) in expectation."""
    enc = GridEncoding(n_dims=3, n_levels=4, n_features_per_level=2,
                       log2_hashmap_size=8, base_resolution=4,
                       per_level_scale=1.5)
    params = jax.random.normal(jax.random.PRNGKey(0),
                               (enc.n_params,)) * 0.3
    n = 128
    x = jax.random.uniform(jax.random.PRNGKey(1), (n, 3), minval=0.05,
                           maxval=0.95)
    comps = tuple(x[:, k] for k in range(3))

    exact = np.asarray(enc.apply_components(params, comps))

    @jax.jit
    def stoch(rng):
        return enc.apply_components(params, comps, rng=rng)

    reps = 3000
    keys = jax.random.split(jax.random.PRNGKey(2), reps)
    acc = np.zeros_like(exact)
    for i in range(0, reps, 500):
        batch = jax.vmap(stoch)(keys[i:i + 500])
        acc += np.asarray(jnp.sum(batch, axis=0))
    mean = acc / reps
    scale = np.abs(exact).max()
    # MC error ~ sigma/sqrt(reps); bf16 packing adds ~0.4% quantization
    np.testing.assert_allclose(mean, exact, atol=scale * 0.08)

    # gradient expectation: dL/dparams of sum(out * W) for fixed W
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                     exact.shape), np.float32)

    def loss_exact(p):
        return jnp.sum(enc.apply_components(p, comps) * w)

    g_exact = np.asarray(jax.grad(loss_exact)(params))

    @jax.jit
    def g_stoch(rng):
        return jax.grad(lambda p: jnp.sum(
            enc.apply_components(p, comps, rng=rng) * w))(params)

    gacc = np.zeros_like(g_exact)
    for i in range(0, reps, 500):
        batch = jax.vmap(g_stoch)(keys[i:i + 500])
        gacc += np.asarray(jnp.sum(batch, axis=0))
    gmean = gacc / reps
    gs = np.abs(g_exact).max()
    np.testing.assert_allclose(gmean, g_exact, atol=gs * 0.08)


def test_stochastic_exact_axes_unbiased_with_lower_variance():
    """stochastic_exact_axes=j enumerates both endpoints along j random
    axes (2^j fetches): still unbiased, and per-entry variance
    drops monotonically with j."""
    import dataclasses

    base = GridEncoding(n_dims=3, n_levels=4, n_features_per_level=2,
                        log2_hashmap_size=8, base_resolution=4,
                        per_level_scale=1.5)
    params = jax.random.normal(jax.random.PRNGKey(0),
                               (base.n_params,)) * 0.3
    n = 96
    x = jax.random.uniform(jax.random.PRNGKey(1), (n, 3), minval=0.05,
                           maxval=0.95)
    comps = tuple(x[:, k] for k in range(3))
    exact = np.asarray(base.apply_components(params, comps))
    scale = np.abs(exact).max()

    reps = 2000
    keys = jax.random.split(jax.random.PRNGKey(2), reps)
    variances = []
    for j in [0, 1, 2]:
        enc = dataclasses.replace(base, stochastic_exact_axes=j)

        @jax.jit
        def stoch(rng, _enc=enc):
            return _enc.apply_components(params, comps, rng=rng)

        acc = np.zeros_like(exact)
        acc2 = np.zeros_like(exact)
        for i in range(0, reps, 500):
            batch = np.asarray(jax.vmap(stoch)(keys[i:i + 500]))
            acc += batch.sum(0)
            acc2 += (batch * batch).sum(0)
        mean = acc / reps
        var = acc2 / reps - mean * mean
        np.testing.assert_allclose(mean, exact, atol=scale * 0.1)
        variances.append(float(var.mean()))
    assert variances[0] > variances[1] > variances[2], variances
    # gradient expectation for j=1 (the production NeRF setting)
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(3), exact.shape),
                   np.float32)
    enc1 = dataclasses.replace(base, stochastic_exact_axes=1)
    g_exact = np.asarray(jax.grad(lambda p: jnp.sum(
        base.apply_components(p, comps) * w))(params))

    @jax.jit
    def g_stoch(rng):
        return jax.grad(lambda p: jnp.sum(
            enc1.apply_components(p, comps, rng=rng) * w))(params)

    gacc = np.zeros_like(g_exact)
    for i in range(0, reps, 500):
        gacc += np.asarray(jnp.sum(jax.vmap(g_stoch)(keys[i:i + 500]),
                                   axis=0))
    np.testing.assert_allclose(gacc / reps, g_exact,
                               atol=np.abs(g_exact).max() * 0.1)


def test_stochastic_bwd_gradient_unbiased():
    """stochastic_bwd: forward uses the axis-exact corners, the table
    gradient scatters at ONE Bernoulli corner — still unbiased."""
    import dataclasses

    base = GridEncoding(n_dims=3, n_levels=4, n_features_per_level=2,
                        log2_hashmap_size=8, base_resolution=4,
                        per_level_scale=1.5)
    enc = dataclasses.replace(base, stochastic_exact_axes=1,
                              stochastic_bwd=True)
    params = jax.random.normal(jax.random.PRNGKey(0),
                               (base.n_params,)) * 0.3
    n = 96
    x = jax.random.uniform(jax.random.PRNGKey(1), (n, 3), minval=0.05,
                           maxval=0.95)
    comps = tuple(x[:, k] for k in range(3))
    exact = np.asarray(base.apply_components(params, comps))
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(3), exact.shape),
                   np.float32)
    g_exact = np.asarray(jax.grad(lambda p: jnp.sum(
        base.apply_components(p, comps) * w))(params))

    @jax.jit
    def g_stoch(rng):
        return jax.grad(lambda p: jnp.sum(
            enc.apply_components(p, comps, rng=rng) * w))(params)

    reps = 2000
    keys = jax.random.split(jax.random.PRNGKey(2), reps)
    gacc = np.zeros_like(g_exact)
    for i in range(0, reps, 500):
        gacc += np.asarray(jnp.sum(jax.vmap(g_stoch)(keys[i:i + 500]),
                                   axis=0))
    np.testing.assert_allclose(gacc / reps, g_exact,
                               atol=np.abs(g_exact).max() * 0.1)


def test_stochastic_corner_max_level_masks():
    enc = GridEncoding(n_dims=2, n_levels=4, n_features_per_level=2,
                       log2_hashmap_size=10, base_resolution=4)
    params = enc.init(jax.random.PRNGKey(0)) + 0.5
    x = jax.random.uniform(jax.random.PRNGKey(1), (64, 2))
    comps = tuple(x[:, k] for k in range(2))
    out = np.asarray(enc.apply_components(
        params, comps, max_level=jnp.asarray(1.0),
        rng=jax.random.PRNGKey(2)))
    assert np.abs(out[:, :4]).max() > 0
    np.testing.assert_allclose(out[:, 4:], 0.0)


def test_f4_packed_matches_per_level_loop():
    """The reference fork's NeRF config uses L=8, F=4 — the packed and
    stochastic fast paths must cover it."""
    enc = GridEncoding(n_dims=3, n_levels=4, n_features_per_level=4,
                       log2_hashmap_size=9, base_resolution=4,
                       per_level_scale=1.7)
    ref = GridEncoding(n_dims=3, n_levels=4, n_features_per_level=4,
                       log2_hashmap_size=9, base_resolution=4,
                       per_level_scale=1.7, packed=False)
    ref.fused = False
    params = jax.random.normal(jax.random.PRNGKey(0),
                               (enc.n_params,)) * 0.3
    x = jax.random.uniform(jax.random.PRNGKey(1), (128, 3))
    comps = tuple(x[:, k] for k in range(3))
    out = np.asarray(enc.apply_components(params, comps))
    loop = np.asarray(ref.apply(params, x))
    scale = np.abs(loop).max()
    np.testing.assert_allclose(out, loop, atol=scale * 8e-3)

    # gradients agree (bf16 fwd tolerance; fp32-exact scatter)
    g1 = jax.grad(lambda p: jnp.sum(
        enc.apply_components(p, comps).astype(jnp.float32) ** 2))(params)
    g2 = jax.grad(lambda p: jnp.sum(
        ref.apply(p, x).astype(jnp.float32) ** 2))(params)
    gs = float(np.abs(np.asarray(g2)).max())
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               atol=gs * 2e-2)


def test_f4_stochastic_unbiased():
    enc = GridEncoding(n_dims=3, n_levels=4, n_features_per_level=4,
                       log2_hashmap_size=8, base_resolution=4,
                       per_level_scale=1.5)
    params = jax.random.normal(jax.random.PRNGKey(0),
                               (enc.n_params,)) * 0.3
    x = jax.random.uniform(jax.random.PRNGKey(1), (128, 3),
                           minval=0.05, maxval=0.95)
    comps = tuple(x[:, k] for k in range(3))
    exact = np.asarray(enc.apply_components(params, comps))

    @jax.jit
    def stoch(rng):
        return enc.apply_components(params, comps, rng=rng)

    reps = 2000
    keys = jax.random.split(jax.random.PRNGKey(2), reps)
    acc = np.zeros_like(exact)
    for i in range(0, reps, 500):
        acc += np.asarray(jnp.sum(jax.vmap(stoch)(keys[i:i + 500]), 0))
    scale = np.abs(exact).max()
    np.testing.assert_allclose(acc / reps, exact, atol=scale * 0.1)


def test_row_mode_matches_planar():
    """The row-gather path (entry-interleaved layout, one 128-float row
    gather per (sample, level, corner)) must
    reproduce the planar unpacked f32 path: same forward values, same
    table gradient (as a set of fp32 adds — scatter order may differ),
    same input gradients."""
    import dataclasses

    for F in (1, 2, 4):
        row = GridEncoding(n_dims=3, n_levels=6, n_features_per_level=F,
                           log2_hashmap_size=12, base_resolution=4,
                           per_level_scale=1.7, row_gather=True)
        assert row._row_mode and row.layout == "interleaved"
        ref = dataclasses.replace(row, row_gather=False, packed=False)
        assert ref.layout == "planar"
        k = jax.random.PRNGKey(0)
        params_p = jax.random.normal(jax.random.fold_in(k, 9),
                                     (ref.n_params,)) * 0.3
        params_r = row.convert_layout(params_p, "planar")
        # layout conversion round-trips
        back = ref.convert_layout(
            np.asarray(params_r).reshape(-1),  # interleaved vector
            "interleaved")
        np.testing.assert_array_equal(np.asarray(back),
                                      np.asarray(params_p))

        x = jax.random.uniform(jax.random.fold_in(k, 1), (512, 3))
        out_r = np.asarray(row.apply(params_r, x))
        out_p = np.asarray(ref.apply(params_p, x))
        np.testing.assert_allclose(out_r, out_p, rtol=1e-6, atol=1e-7)

        # table gradient (converted back to planar for comparison)
        def table_grad(e, p):
            return jax.grad(lambda pp: jnp.sum(
                jnp.sin(e.apply(pp, x) * 3.0)))(p)

        g_r = ref.convert_layout(table_grad(row, params_r), "interleaved")
        g_p = table_grad(ref, params_p)
        gs = float(np.abs(np.asarray(g_p)).max())
        np.testing.assert_allclose(np.asarray(g_r), np.asarray(g_p),
                                   atol=max(gs, 1.0) * 1e-6)

        # input gradients (camera-opt / Normals path)
        def in_grad(e, p):
            return jax.grad(lambda xx: jnp.sum(
                e.apply(p, xx) ** 2))(x)

        np.testing.assert_allclose(np.asarray(in_grad(row, params_r)),
                                   np.asarray(in_grad(ref, params_p)),
                                   rtol=1e-4, atol=1e-5)

        # stochastic estimator: same RNG -> same corner choices; the row
        # fetch is f32 so it matches the planar-packed path to bf16
        # quantization only — check against itself for determinism and
        # against packed within tolerance (F even only)
        if F % 2 == 0:
            srng = jax.random.PRNGKey(7)
            packed = dataclasses.replace(row, row_gather=False,
                                         packed=True)
            comps = [x[:, i] for i in range(3)]
            o_row = np.asarray(row.apply_components(params_r, comps,
                                                    rng=srng))
            o_pk = np.asarray(packed.apply_components(params_p, comps,
                                                      rng=srng))
            scale = max(float(np.abs(o_pk).max()), 1e-6)
            np.testing.assert_allclose(o_row, o_pk, atol=scale * 8e-3)


def test_bwd_coalesce_gradient_matches_plain():
    """bwd_coalesce (sorted + segment-merged deposits, merged lanes
    dropped OOB) must produce the same table gradient as the plain row
    deposit — it only reorders/merges float adds."""
    import dataclasses

    plain = GridEncoding(n_dims=3, n_levels=4, n_features_per_level=4,
                         log2_hashmap_size=10, base_resolution=4,
                         per_level_scale=1.9, row_gather=True)
    coal = dataclasses.replace(plain, bwd_coalesce=True)
    assert plain._row_mode
    k = jax.random.PRNGKey(3)
    params = jax.random.normal(jax.random.fold_in(k, 1),
                               (plain.n_params,)) * 0.2
    # duplicate-heavy batch: coarse levels map many samples per entry
    x = jax.random.uniform(jax.random.fold_in(k, 2), (2048, 3))

    def table_grad(enc):
        return jax.grad(lambda p: jnp.sum(
            jnp.cos(enc.apply(p, x) * 2.0)))(params)

    g_plain = np.asarray(table_grad(plain))
    g_coal = np.asarray(table_grad(coal))
    scale = max(float(np.abs(g_plain).max()), 1.0)
    np.testing.assert_allclose(g_coal, g_plain, atol=scale * 1e-5)
    assert np.abs(g_plain).max() > 0


def test_bwd_coalesce_rejected_without_row_mode():
    """bwd_coalesce only changes the row backward: on the default planar
    encoder, directly or from a config, it is an error, not a no-op."""
    with pytest.raises(ValueError, match="row_gather"):
        GridEncoding(n_dims=3, n_levels=2, log2_hashmap_size=10,
                     bwd_coalesce=True)
    with pytest.raises(ValueError, match="row_gather"):
        GridEncoding.from_config(3, {"otype": "HashGrid", "n_levels": 2,
                                     "bwd_coalesce": True})


def _f32_dots(jaxpr):
    """dot_general equations with a float32 operand at default precision,
    searched through every sub-jaxpr (custom VJPs, maps, loops)."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            prec = eqn.params.get("precision")
            highest = prec is not None and all(
                p == jax.lax.Precision.HIGHEST for p in
                (prec if isinstance(prec, tuple) else (prec,)))
            if not highest and any(v.aval.dtype == jnp.float32
                                   for v in eqn.invars):
                found.append(eqn)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found += _f32_dots(sub)
    return found


@pytest.mark.parametrize("path", ["flat", "row", "packed", "stochastic",
                                  "row-stochastic"])
def test_encode_has_no_default_precision_f32_dot(path):
    """On GPUs an f32 matmul at default precision runs in TF32 (a 10-bit
    mantissa); no such dot may remain in the encode's forward or
    backward, on any path."""
    import dataclasses

    enc = GridEncoding.from_config(3, {
        "otype": "HashGrid", "n_levels": 4, "n_features_per_level": 4,
        "log2_hashmap_size": 12, "base_resolution": 4,
        "stochastic_exact_axes": 1, "stochastic_bwd": True})
    enc = dataclasses.replace(enc, row_gather=path.startswith("row"),
                              packed=path == "packed")
    params = enc.init(jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (64, 3))
    rng = jax.random.PRNGKey(2) if path.endswith("stochastic") else None

    def loss(p, x):
        return jnp.sum(enc.apply(p, x, max_level=jnp.asarray(2.0),
                                 rng=rng) ** 2)

    jaxpr = jax.make_jaxpr(jax.grad(loss, argnums=(0, 1)))(params, x)
    assert not _f32_dots(jaxpr.jaxpr), path
