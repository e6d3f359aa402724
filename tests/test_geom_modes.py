"""Tests: BVH, marching tetrahedra, SDF mode, volume mode, geometry mode,
camera path, FLIP."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

SMALL_NET = {
    "loss": {"otype": "MAPE"},
    "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {
        "otype": "ExponentialDecay", "decay_start": 10000,
        "decay_interval": 5000, "decay_base": 0.33, "nested": {
            "otype": "Adam", "learning_rate": 2e-3, "beta1": 0.9,
            "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}}},
    "encoding": {"otype": "HashGrid", "n_levels": 6,
                 "n_features_per_level": 2, "log2_hashmap_size": 13,
                 "base_resolution": 8},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "None", "n_neurons": 32,
                "n_hidden_layers": 2},
}


def make_box_mesh(lo=0.3, hi=0.7):
    """12-triangle axis-aligned box."""
    v = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                  for z in (lo, hi)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, c, d in quads:
        tris.append([v[a], v[b], v[c]])
        tris.append([v[a], v[c], v[d]])
    return np.asarray(tris, np.float32)


# ---------------------------------------------------------------------------
# native BVH
# ---------------------------------------------------------------------------

def test_bvh_signed_distance_box():
    from instant_ngp_tpu.geom import TriangleBvh

    bvh = TriangleBvh(make_box_mesh())
    pts = np.array([[0.5, 0.5, 0.5],    # center: inside, dist 0.2
                    [0.5, 0.5, 0.9],    # outside, dist 0.2
                    [0.5, 0.5, 0.75]], np.float32)
    d = bvh.signed_distance(pts, "Raystab")
    assert d[0] < 0 and abs(abs(d[0]) - 0.2) < 1e-3
    assert d[1] > 0 and abs(d[1] - 0.2) < 1e-3
    assert d[2] > 0 and abs(d[2] - 0.05) < 1e-3


def test_bvh_ray_trace_box():
    from instant_ngp_tpu.geom import TriangleBvh

    bvh = TriangleBvh(make_box_mesh())
    o = np.array([[0.5, 0.5, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    t, idx = bvh.ray_trace(o, d)
    assert idx[0] >= 0
    assert abs(t[0] - 0.3) < 1e-4


# ---------------------------------------------------------------------------
# marching tetrahedra
# ---------------------------------------------------------------------------

def test_marching_tets_sphere_radius():
    from instant_ngp_tpu.geom.marching import marching_tetrahedra

    g = np.mgrid[0:32, 0:32, 0:32].astype(np.float32) / 31 - 0.5
    field = np.sqrt((g ** 2).sum(0)) - 0.3
    v, f = marching_tetrahedra(field, 0.0)
    assert len(v) > 100 and len(f) > 100
    r = np.linalg.norm(v - v.mean(0), axis=-1)
    assert abs(r.mean() - 0.3) < 0.01
    assert r.std() < 0.01


def test_marching_cubes_sphere():
    """Generated-table MC: exact radius, watertight, outward normals."""
    from instant_ngp_tpu.geom.marching_cubes import marching_cubes

    g = np.mgrid[0:32, 0:32, 0:32].astype(np.float32) / 31 - 0.5
    field = np.sqrt((g ** 2).sum(0)) - 0.3
    v, f = marching_cubes(field, 0.0, spacing=np.full(3, 1 / 31.0),
                          origin=np.full(3, -0.5))
    assert len(v) > 100 and len(f) > 100
    r = np.linalg.norm(v - v.mean(0), axis=-1)
    assert abs(r.mean() - 0.3) < 0.005
    assert r.std() < 0.005
    # watertight with consistent winding: every directed edge matched
    # by its reverse exactly once
    edges = {}
    for a, b, c in f:
        for u, w in ((a, b), (b, c), (c, a)):
            edges[(u, w)] = edges.get((u, w), 0) + 1
    assert all(cnt == 1 and edges.get((w, u)) == 1
               for (u, w), cnt in edges.items())
    # outward orientation: positive divergence-theorem volume ~ sphere
    vol = sum(np.dot(v[a], np.cross(v[b], v[c])) for a, b, c in f) / 6.0
    assert abs(vol - 4 / 3 * np.pi * 0.3 ** 3) < 0.01 * 4 * 0.3 ** 3


def test_marching_cubes_random_fields_watertight():
    """Random fields hammer the ambiguous configurations; the mesh must
    stay closed with consistent winding (the classic MC hole bug would
    show up here). Note the table is intentionally NOT complement-
    symmetric — that symmetry is exactly what causes holes."""
    from instant_ngp_tpu.geom.marching_cubes import N_TRIS, marching_cubes

    assert N_TRIS.max() == 5 and N_TRIS[0] == 0 and N_TRIS[255] == 0
    rng = np.random.RandomState(0)
    for trial in range(3):
        field = rng.randn(6, 6, 6).astype(np.float32)
        field[0] = field[-1] = 1.0  # close at the border
        field[:, 0] = field[:, -1] = 1.0
        field[:, :, 0] = field[:, :, -1] = 1.0
        v, f = marching_cubes(field, 0.0)
        assert len(f) > 0
        edges = {}
        for a, b, c in f:
            for u, w in ((a, b), (b, c), (c, a)):
                edges[(u, w)] = edges.get((u, w), 0) + 1
        unmatched = [e for (u, w), cnt in edges.items()
                     for e in [(u, w)]
                     if cnt != 1 or edges.get((w, u)) != 1]
        assert not unmatched, f"trial {trial}: {len(unmatched)} bad edges"


def test_mesh_save_load_roundtrip(tmp_path):
    from instant_ngp_tpu.geom.marching import marching_tetrahedra, save_mesh
    from instant_ngp_tpu.geom.triangle_bvh import load_obj

    g = np.mgrid[0:16, 0:16, 0:16].astype(np.float32) / 15 - 0.5
    field = np.abs(g).max(0) - 0.25
    v, f = marching_tetrahedra(field, 0.0)
    p = str(tmp_path / "m.obj")
    save_mesh(p, v, f)
    tris = load_obj(p)
    assert tris.shape == (len(f), 3, 3)


# ---------------------------------------------------------------------------
# SDF mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sdf_testbed():
    from instant_ngp_tpu.sdf import SdfTestbed

    tb = SdfTestbed(make_box_mesh(0.0, 1.0), SMALL_NET,
                    compute_dtype=jnp.float32)
    tb.train(40, batch_size=1 << 12)
    return tb


def test_sdf_training_and_iou(sdf_testbed):
    assert np.isfinite(sdf_testbed.loss_scalar)
    iou = sdf_testbed.calculate_iou(1 << 14)
    assert 0.0 < iou <= 1.0


def test_sdf_sample_mix():
    from instant_ngp_tpu.sdf import SdfTestbed

    tb = SdfTestbed(make_box_mesh(), SMALL_NET, compute_dtype=jnp.float32)
    pos, dist = tb.generate_training_samples(1024)
    assert pos.shape == (1024, 3) and dist.shape == (1024,)
    # first half (surface-exact) has zero distance
    assert np.abs(dist[:512]).max() == 0.0
    assert np.isfinite(dist).all()


def test_sdf_render_modes(sdf_testbed):
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, -1, 2.2]],
                   np.float32)
    for mode in ("Shade", "Normals", "Depth"):
        img = sdf_testbed.render_frame(24, 24, cam, render_mode=mode)
        assert img.shape == (24, 24, 4)
        assert np.isfinite(img).all()
    gt = sdf_testbed.render_frame(24, 24, cam, use_gt=True)
    assert gt[..., 3].sum() > 0  # the box is visible


def test_sdf_gt_modes_agree(sdf_testbed):
    """All three GT oracles must silhouette the same box."""
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, -1, 2.2]],
                   np.float32)
    imgs = {}
    for mode in ("RaytracedMesh", "SDFBricks", "SpheretracedMesh"):
        sdf_testbed.groundtruth_mode = mode
        imgs[mode] = sdf_testbed.render_frame(24, 24, cam, use_gt=True)
        assert np.isfinite(imgs[mode]).all()
    sdf_testbed.groundtruth_mode = "RaytracedMesh"
    ref_sil = imgs["RaytracedMesh"][..., 3] > 0.5
    for mode in ("SDFBricks", "SpheretracedMesh"):
        sil = imgs[mode][..., 3] > 0.5
        agree = (sil == ref_sil).mean()
        assert agree > 0.9, f"{mode} silhouette only {agree:.2f} match"


def test_sdf_bricks_distance_accuracy():
    """Brick-interpolated SDF matches the exact BVH SDF off-lattice."""
    from instant_ngp_tpu.geom.triangle_bvh import TriangleBvh
    from instant_ngp_tpu.geom.triangle_octree import TriangleOctree
    from instant_ngp_tpu.sdf.bricks import SdfBricks

    tris = make_box_mesh(0.25, 0.75)
    bvh = TriangleBvh(tris)
    octree = TriangleOctree(tris, 4)
    bricks = SdfBricks(octree, bvh, brick_res=5, brick_level=3)
    rng = np.random.RandomState(1)
    pos = (rng.rand(256, 3) * 0.5 + 0.25).astype(np.float32)  # near box
    want = bvh.signed_distance(pos, mode="Watertight")
    got = np.asarray(bricks.distance(jnp.asarray(pos)))
    occ = np.asarray(octree.contains(jnp.asarray(pos), bricks.level))
    err = np.abs(got[occ] - want[occ])
    assert occ.sum() > 50
    assert err.max() < 0.05  # trilinear error at 1/8-cell lattices


# ---------------------------------------------------------------------------
# volume mode
# ---------------------------------------------------------------------------

def test_volume_train_and_render():
    from instant_ngp_tpu.volume import VolumeTestbed

    g = np.mgrid[0:32, 0:32, 0:32].astype(np.float32) / 32 - 0.5
    dens = 5.0 * np.exp(-np.sum(g ** 2, 0) / 0.02).astype(np.float32)
    dens[dens < 0.01] = 0
    cfg = dict(SMALL_NET, loss={"otype": "L2"})
    cfg["network"] = dict(SMALL_NET["network"], output_activation="ReLU")
    tb = VolumeTestbed(dens, cfg, compute_dtype=jnp.float32)
    l0 = tb.train(3, batch_size=1 << 10)
    l1 = tb.train(30, batch_size=1 << 10)
    assert np.isfinite(l1) and l1 < l0 * 1.5
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, 1, -1.6]],
                   np.float32)
    img = tb.render_frame(24, 24, cam)
    assert img.shape == (24, 24, 4) and np.isfinite(img).all()
    gt = tb.render_frame(24, 24, cam, use_gt=True)
    assert gt[..., 3].mean() >= 0


def test_nanovdb_header_rejects_garbage(tmp_path):
    from instant_ngp_tpu.volume import load_nanovdb_header

    p = str(tmp_path / "x.nvdb")
    with open(p, "wb") as f:
        f.write(b"\x00" * 256)
    with pytest.raises(ValueError):
        load_nanovdb_header(p)


# ---------------------------------------------------------------------------
# geometry mode
# ---------------------------------------------------------------------------

def test_geometry_scene(tmp_path):
    import json

    from instant_ngp_tpu.geom.marching import save_mesh
    from instant_ngp_tpu.geometry import GeometryTestbed

    box = make_box_mesh(-0.5, 0.5)
    obj = str(tmp_path / "box.obj")
    # save as soup obj
    verts = box.reshape(-1, 3)
    faces = np.arange(len(verts)).reshape(-1, 3)
    save_mesh(obj, verts, faces)
    scene = {"geometry": [
        {"center": [0.0, 0.0, 0.0], "path": obj, "type": "Mesh"},
        {"center": [2.0, 0.0, 0.0], "path": obj, "type": "Mesh"},
    ]}
    scene_path = str(tmp_path / "scene.json")
    with open(scene_path, "w") as f:
        json.dump(scene, f)

    tb = GeometryTestbed(scene_path)
    assert len(tb.meshes) == 2
    cam = np.array([[1, 0, 0, 1.0], [0, -1, 0, 0.0], [0, 0, 1, -3.0]],
                   np.float32)
    img = tb.render_frame(32, 32, cam)
    assert img[..., 3].sum() > 0  # both boxes visible
    t, obj_idx, tri = tb.trace_meshes(
        np.array([[0.0, 0.0, -2.0], [2.0, 0.0, -2.0]], np.float32),
        np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32))
    assert obj_idx[0] == 0 and obj_idx[1] == 1
    assert abs(t[0] - 1.5) < 1e-3


def test_geometry_nerf_object_loads_either_grid_layout(tmp_path):
    """A NeRF snapshot saved from a row-gather (entry-interleaved) encoder
    loads into a geometry scene's default (planar) encoder with the same
    hash table, and marches the same colours as its planar twin."""
    import dataclasses
    import json
    import sys

    from instant_ngp_tpu.geometry import GeometryTestbed
    from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed
    sys.path.insert(0, os.path.dirname(__file__))
    from test_nerf_training import CFG, make_dataset

    nerf = NerfTestbed(make_dataset(), CFG)
    enc = nerf.model.pos_encoding
    nerf.state["params"]["pos_encoding"] = jax.random.normal(
        jax.random.PRNGKey(0), (enc.n_params,))
    nerf.save_snapshot(str(tmp_path / "planar.ingp"))
    row = dataclasses.replace(enc, row_gather=True)
    nerf.state = row.convert_state_layout(nerf.state, enc.layout)
    nerf.model.pos_encoding = row
    nerf.save_snapshot(str(tmp_path / "interleaved.ingp"))

    scene_path = str(tmp_path / "scene.json")
    with open(scene_path, "w") as f:
        json.dump({"geometry": [
            {"center": [0.0, 0.0, 0.0], "path": name, "type": "Nerf"}
            for name in ("interleaved.ingp", "planar.ingp")]}, f)
    geo = GeometryTestbed(scene_path)
    loaded, twin = geo.nerfs
    assert loaded.model.pos_encoding.layout == "planar"
    np.testing.assert_array_equal(
        np.asarray(loaded.params["pos_encoding"]),
        np.asarray(twin.params["pos_encoding"]))

    o = np.tile(np.array([[0.5, 0.5, -1.0]], np.float32), (8, 1))
    o[:, 0] += np.linspace(-0.3, 0.3, 8, dtype=np.float32)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (8, 1))
    t_max = np.full(8, 10.0, np.float32)
    for a, b in zip(geo._march_nerf_object(loaded, o, d, t_max),
                    geo._march_nerf_object(twin, o, d, t_max)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# camera path
# ---------------------------------------------------------------------------

def test_camera_path_spline_and_io(tmp_path):
    from instant_ngp_tpu.camera_path import CameraKeyframe, CameraPath

    cp = CameraPath()
    for i in range(4):
        m = np.eye(3, 4, dtype=np.float32)
        m[:3, 3] = [i, 0, 0]
        cp.keyframes.append(CameraKeyframe.from_matrix(m, fov=40 + i))
    kf = cp.eval(0.0)
    np.testing.assert_allclose(kf.T, [0, 0, 0], atol=1e-5)
    kf = cp.eval(1.0)
    np.testing.assert_allclose(kf.T, [3, 0, 0], atol=1e-5)
    mid = cp.eval(0.5)
    assert 1.0 < mid.T[0] < 2.0
    m = mid.matrix()
    np.testing.assert_allclose(m[:3, :3] @ m[:3, :3].T, np.eye(3),
                               atol=1e-5)

    p = str(tmp_path / "path.json")
    cp.save(p)
    cp2 = CameraPath.load(p)
    assert len(cp2.keyframes) == 4
    np.testing.assert_allclose(cp2.eval(0.25).T, cp.eval(0.25).T,
                               atol=1e-6)


def test_camera_path_video_frames(tmp_path):
    """render_video writes one PNG per path frame through a real NeRF
    render and returns the frames dir when ffmpeg is absent
    (run.py:304-338 equivalent)."""
    import os

    from test_nerf_training import CFG, make_dataset

    from instant_ngp_tpu.camera_path import (CameraKeyframe, CameraPath,
                                             render_video)
    from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed

    tb = NerfTestbed(make_dataset(), CFG, compute_dtype=jnp.float32)
    tb.target_batch_size = 1 << 10
    tb.rays_per_batch = 256
    tb.n_march = 64
    tb.max_samples_per_ray = 16
    tb.density_samples_override = 1 << 10
    tb.train(3)

    cp = CameraPath()
    cp.resolution = (32, 18)
    cp.spp = 1
    cp.fps = 3.0
    cp.duration_seconds = 1.0
    for i in range(2):
        m = np.asarray(tb.data.xforms_start[i], np.float32)
        cp.keyframes.append(CameraKeyframe.from_matrix(m, fov=40))

    class _Facade:
        mode = None

        def render(self, w, h, spp=1, camera_matrix=None, **kw):
            return tb.render_frame(w, h, camera_matrix, spp=spp)

    out = render_video(_Facade(), cp, str(tmp_path / "vid"))
    frames = sorted(os.listdir(tmp_path / "vid"))
    pngs = [f for f in frames if f.endswith(".png")]
    assert len(pngs) == cp.n_frames()
    assert pngs[0] == "frame_00000.png"


# ---------------------------------------------------------------------------
# FLIP
# ---------------------------------------------------------------------------

def test_flip_zero_for_identical():
    from instant_ngp_tpu.metrics_flip import compute_flip

    img = np.random.RandomState(0).rand(32, 32, 3).astype(np.float32)
    err = compute_flip(img, img)
    assert err.shape == (32, 32)
    assert err.max() < 1e-6


def test_flip_increases_with_distortion():
    from instant_ngp_tpu.metrics_flip import compute_flip

    rng = np.random.RandomState(1)
    ref = np.clip(rng.rand(32, 32, 3), 0, 1)
    small = np.clip(ref + 0.02 * rng.randn(32, 32, 3), 0, 1)
    big = np.clip(ref + 0.3 * rng.randn(32, 32, 3), 0, 1)
    assert compute_flip(ref, small).mean() < compute_flip(ref, big).mean()


def test_metrics_dispatch_flip():
    from instant_ngp_tpu.metrics import compute_error

    rng = np.random.RandomState(2)
    a = rng.rand(24, 24, 3).astype(np.float32)
    assert compute_error("FLIP", a, a) < 1e-6
    assert compute_error("SSIM", a, a) > 0.99
