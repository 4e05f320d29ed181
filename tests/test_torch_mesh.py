"""The mesh queries and iso-surface extraction of the PyTorch port, held
against the JAX package on the same numpy inputs: ``ops/mesh.py``
(``closest_point_triangle``, ``nearest_points``, ``winding_number``,
``inside_mesh``, ``ray_mesh_hit``, ``MeshSearcher``), ``ops/marching.py``
(``marching_tetrahedra``, ``laplacian_smooth``, ``vertex_normals``),
``reconstruct_gnr`` on an analytic sphere, and the native uniform-grid
searcher (``xrnerf_torch/native``) against the port's dense queries. Mirrors
``tests/test_mesh_ops.py`` and ``tests/test_marching.py``.

Tolerances. f32 both sides: functions rtol 1e-4 / atol 1e-5, closest points
atol 1e-4 (the JAX package's own native-vs-jnp bar). Face indices: where
JAX's best squared distance beats every other face by more than the
relative margin ``TIE`` (1e-6) the port picks JAX's face; elsewhere (a point
whose nearest feature is an edge or a vertex shared by faces, where the two
packages round the faces' distances differently) the port's face must be
within that margin of JAX's best in JAX's own distances. Signs equal
wherever |w - 0.5| > 1e-5. numpy copies (marching) equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import xrnerf_tpu.ops.marching as jmarch  # noqa: E402
import xrnerf_tpu.ops.mesh as jmesh  # noqa: E402
import xrnerf_torch.ops.marching as tmarch  # noqa: E402
import xrnerf_torch.ops.mesh as tmesh  # noqa: E402
from xrnerf_torch.datasets.load.synthetic import make_icosphere  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
CP_ATOL = 1e-4  # tests/test_mesh_ops.py:108
TIE = 1e-6  # relative margin of a near-tie in squared distance
W_EPS = 1e-5  # |w - 0.5| below which the sign is not compared


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def make_cube():
    """The cube [-1, 1]^3 as 12 outward triangles (tests/test_mesh_ops.py)."""
    v = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [2, 3, 7], [2, 7, 6], [0, 4, 7], [0, 7, 3], [1, 2, 6], [1, 6, 5]], np.int32)
    return v, f


MESHES = {
    "cube": (make_cube, 2.5),
    "icosphere_128": (lambda: make_icosphere(2, 0.3), 0.45),
    "icosphere_2048": (lambda: make_icosphere(4, 0.3), 0.45),
}


def _points(extent, n=4096, seed=0):
    return np.random.RandomState(seed).uniform(-extent, extent, (n, 3)).astype(np.float32)


def test_nearest_point_on_cube():
    v, f = make_cube()
    pts = np.array([[0.0, 0.0, 2.0], [3.0, 0.0, 0.0], [2.0, 2.0, 2.0], [0.5, 0.5, 0.5]], np.float32)
    best, idx, dist = (x.numpy() for x in tmesh.nearest_points(_t(pts), _t(v), _t(f), chunk=4))
    np.testing.assert_allclose(best[:3], [[0, 0, 1], [1, 0, 0], [1, 1, 1]], atol=1e-5)
    np.testing.assert_allclose(dist, [1.0, 2.0, np.sqrt(3), 0.5], atol=1e-5)
    assert idx.dtype == np.int32


def test_closest_point_triangle_matches_jax():
    rng = np.random.RandomState(3)
    p, a, b, c = (rng.randn(64, 5, 3).astype(np.float32) for _ in range(4))
    a[:, 0] = b[:, 0]  # a degenerate triangle per row
    want = np.asarray(jmesh.closest_point_triangle(*(jnp.asarray(x) for x in (p, a, b, c))))
    got = tmesh.closest_point_triangle(*(_t(x) for x in (p, a, b, c))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_nearest_points_match_jax(mesh, capsys):
    make, extent = MESHES[mesh]
    v, f = make()
    pts = _points(extent)
    jb, ji, jd = (np.asarray(x) for x in jmesh.nearest_points(pts, v, f, chunk=128))
    tb, ti, td = (x.numpy() for x in tmesh.nearest_points(_t(pts), _t(v), _t(f), chunk=128))
    np.testing.assert_allclose(tb, jb, atol=CP_ATOL)
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    # JAX's squared distance to every face, in JAX's arithmetic
    cp = np.asarray(jmesh.closest_point_triangle(jnp.asarray(pts)[:, None], *(jnp.asarray(v[f[:, k]])[None]
                                                                              for k in range(3))))
    d2 = ((pts[:, None] - cp) ** 2).sum(-1)
    rows = np.arange(len(pts))
    best = d2[rows, ji]
    gap = (np.sort(d2, 1)[:, 1] - best) / np.maximum(best, 1e-30) if len(f) > 1 else np.full(len(pts), np.inf)
    clear = gap > TIE
    np.testing.assert_array_equal(ti[clear], ji[clear])
    assert np.all(d2[rows, ti] <= best * (1 + TIE) + 1e-12)
    differ = float(np.mean(ti != ji))
    with capsys.disabled():
        print(f"\n{mesh}: near-tie share {1 - clear.mean():.4f}, face index differs from JAX's on {differ:.4f}")
    assert differ < 0.1


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_winding_and_inside_match_jax(mesh):
    make, extent = MESHES[mesh]
    v, f = make()
    pts = _points(extent, seed=1)
    jw = np.asarray(jmesh.winding_number(pts, v, f, chunk=256))
    tw = tmesh.winding_number(_t(pts), _t(v), _t(f), chunk=256).numpy()
    np.testing.assert_allclose(tw, jw, rtol=RTOL, atol=ATOL)
    js = np.asarray(jmesh.inside_mesh(pts, v, f, chunk=256))
    ts = tmesh.inside_mesh(_t(pts), _t(v), _t(f), chunk=256).numpy()
    sure = np.abs(jw - 0.5) > W_EPS
    np.testing.assert_array_equal(ts[sure], js[sure])
    assert set(np.unique(ts)) <= {-1.0, 1.0}


def test_winding_inside_cube():
    v, f = make_cube()
    inside = np.random.RandomState(0).uniform(-0.9, 0.9, (64, 3)).astype(np.float32)
    outside = inside + np.array([3.0, 0, 0], np.float32)
    np.testing.assert_allclose(tmesh.winding_number(_t(inside), _t(v), _t(f)).numpy(), 1.0, atol=1e-4)
    np.testing.assert_allclose(tmesh.winding_number(_t(outside), _t(v), _t(f)).numpy(), 0.0, atol=1e-4)
    s = tmesh.inside_mesh(_t(np.concatenate([inside, outside])), _t(v), _t(f)).numpy()
    assert np.all(s[:64] == 1.0) and np.all(s[64:] == -1.0)


def test_chunk_size_is_not_semantics():
    """Rows are independent: any chunk (and the CPU's tile cap) gives the same bits."""
    v, f = make_icosphere(3, 0.3)
    pts = _t(_points(0.45, n=300, seed=2))
    ref = tmesh.nearest_points(pts, _t(v), _t(f), chunk=4096)
    wref = tmesh.winding_number(pts, _t(v), _t(f), chunk=4096)
    for chunk in (1, 7, 128):
        got = tmesh.nearest_points(pts, _t(v), _t(f), chunk=chunk)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert torch.equal(tmesh.winding_number(pts, _t(v), _t(f), chunk=chunk), wref)


def test_ray_hit_cube_and_jax():
    v, f = make_cube()
    o = np.array([[0, 0, 5.0], [0, 0, 5.0], [5.0, 5.0, 5.0]], np.float32)
    d = np.array([[0, 0, -1.0], [0, 0, 1.0], [-1.0, -1.0, -1.0]], np.float32)
    assert tmesh.ray_mesh_hit(_t(o), _t(d), _t(v), _t(f), chunk=4).tolist() == [True, False, True]
    assert tmesh.ray_mesh_hit(_t(o[:1]), _t(d[:1]), _t(v), _t(f), t_max=3.0).tolist() == [False]
    rng = np.random.RandomState(4)
    vs, fs = make_icosphere(3, 0.3)
    o = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    d = rng.randn(500, 3).astype(np.float32)
    want = np.asarray(jmesh.ray_mesh_hit(o, d, vs, fs, chunk=128))
    got = tmesh.ray_mesh_hit(_t(o), _t(d), _t(vs), _t(fs), chunk=128).numpy()
    np.testing.assert_array_equal(got, want)


def test_mesh_searcher_api():
    v, f = make_cube()
    ms = tmesh.MeshSearcher(v, f)
    best, idx = ms.nearest_points(np.array([[0, 0, 3.0]], np.float32))
    np.testing.assert_allclose(best.numpy()[0], [0, 0, 1], atol=1e-5)
    s = ms.inside_mesh(np.array([[0, 0, 0.0], [0, 0, 3.0]], np.float32)).numpy()
    assert s.tolist() == [1.0, -1.0]
    assert ms.intersects(np.array([[0, 0, 5.0]], np.float32), np.array([[0, 0, -1.0]], np.float32)).tolist() == [True]


# --- marching tetrahedra, smoothing, normals: numpy copies ---


def sphere_volume(n=32, radius=10.0):
    lin = np.arange(n) - n / 2
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return 1.0 / (1.0 + np.exp(-(radius - np.sqrt(x * x + y * y + z * z)))), n


def test_marching_tets_sphere_matches_jax():
    vol, n = sphere_volume()
    verts, faces = tmarch.marching_tetrahedra(vol, level=0.5)
    jv, jf = jmarch.marching_tetrahedra(vol, level=0.5)
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(faces, jf)
    r = np.linalg.norm(verts - n / 2, axis=-1)
    assert len(faces) > 100 and abs(r.mean() - 10.0) < 0.5 and r.std() < 0.5
    edges = {}
    for fa in faces:
        for e in ((fa[0], fa[1]), (fa[1], fa[2]), (fa[2], fa[0])):
            k = tuple(sorted(e))
            edges[k] = edges.get(k, 0) + 1
    assert (np.asarray(list(edges.values())) == 2).mean() > 0.99  # closed surface


def test_marching_tets_empty():
    verts, faces = tmarch.marching_tetrahedra(np.zeros((8, 8, 8)), 0.5)
    assert len(verts) == 0 and len(faces) == 0


def test_smoothing_and_normals_match_jax():
    vol, n = sphere_volume()
    verts, faces = tmarch.marching_tetrahedra(vol, 0.5)
    noisy = verts + 0.2 * np.random.RandomState(0).randn(*verts.shape).astype(np.float32)
    sm = tmarch.laplacian_smooth(noisy, faces, iterations=5)
    np.testing.assert_array_equal(sm, jmarch.laplacian_smooth(noisy, faces, iterations=5))
    assert np.linalg.norm(sm - n / 2, axis=-1).std() < np.linalg.norm(noisy - n / 2, axis=-1).std()
    vn = tmarch.vertex_normals(verts, faces)
    np.testing.assert_array_equal(vn, jmarch.vertex_normals(verts, faces))
    radial = (verts - n / 2) / np.linalg.norm(verts - n / 2, axis=-1, keepdims=True)
    assert np.abs(np.sum(vn * radial, -1)).mean() > 0.9


def test_reconstruct_sphere_matches_jax():
    """``reconstruct_gnr`` on an analytic occupancy sphere: the same mesh as
    the JAX driver (faces equal, vertices at the f32 bar) and on the sphere."""
    import jax

    from xrnerf_tpu.models.renders.gnr_render import reconstruct_gnr as jrecon
    from xrnerf_torch.models.renders.gnr_render import reconstruct_gnr

    center = np.array([0.3, -0.2, 0.1], np.float32)
    r0 = 0.25
    kw = dict(center=center, spatial_freq=64.0, load_size=64, n_grid=32, chunk=8192, laplacian=2)
    verts, faces, rgbs = reconstruct_gnr(
        lambda p: torch.sigmoid(200.0 * (r0 - torch.linalg.norm(p - _t(center), dim=-1))),
        lambda p, nrm: torch.clamp(0.5 * (nrm + 1.0), 0, 1), **kw)
    jv, jf, jc = jrecon(lambda p: jax.nn.sigmoid(200.0 * (r0 - jnp.linalg.norm(p - center, axis=-1))),
                        lambda p, nrm: jnp.clip(0.5 * (nrm + 1.0), 0, 1), **kw)
    np.testing.assert_array_equal(faces, jf)
    np.testing.assert_allclose(verts, jv, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rgbs, jc, rtol=RTOL, atol=1e-4)
    assert len(verts) > 50 and abs(np.linalg.norm(verts - center, axis=-1).mean() - r0) < 0.05


# --- the native uniform-grid searcher against the port's dense queries ---

needs_gxx = pytest.mark.skipif(__import__("shutil").which("g++") is None,
                               reason="no g++ to build xrnerf_torch/native/mesh_grid.cpp")


@needs_gxx
@pytest.mark.parametrize("mesh", ["cube", "icosphere_128"])
def test_native_searcher_matches_port(mesh):
    from xrnerf_torch.native.mesh_grid_searcher import NativeMeshSearcher

    make, extent = MESHES[mesh]
    v, f = make()
    ms = NativeMeshSearcher(v, f)
    rng = np.random.RandomState(0)
    pts = rng.uniform(-extent, extent, (300, 3)).astype(np.float32)
    best_n, _ = ms.nearest_points(pts)
    best_t, _, _ = tmesh.nearest_points(_t(pts), _t(v), _t(f), chunk=256)
    np.testing.assert_allclose(best_n, best_t.numpy(), atol=CP_ATOL)
    w = tmesh.winding_number(_t(pts), _t(v), _t(f)).numpy()
    sure = np.abs(w - 0.5) > W_EPS
    np.testing.assert_array_equal(ms.inside_mesh(pts)[sure], tmesh.inside_mesh(_t(pts), _t(v), _t(f)).numpy()[sure])
    o = rng.uniform(-1.2 * extent, 1.2 * extent, (200, 3)).astype(np.float32)
    o[np.all(np.abs(o) < extent / 2, axis=1)] += extent  # origins outside the mesh
    d = rng.randn(200, 3).astype(np.float32)
    hit_t = tmesh.ray_mesh_hit(_t(o), _t(d), _t(v), _t(f)).numpy()
    assert (ms.intersects(o, d) == hit_t).mean() >= 0.98  # the grid walk can graze edges


@needs_gxx
def test_native_build_goes_to_the_port_and_raises_without_compiler(monkeypatch, tmp_path):
    """The library is built under ``xrnerf_torch/_build/``; with no ``g++``
    the build raises instead of falling back."""
    import xrnerf_torch.native as native

    path = native.build()
    assert path.parent.name == "_build" and path.parent.parent.name == "xrnerf_torch" and path.exists()
    monkeypatch.setattr(native, "lib_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        native.build()
