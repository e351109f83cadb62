"""The PyTorch port's front from a config to the staged path against the JAX
package's: utils/config.expand_parameters (the parameter records field by
field), models/pipeline.staged_envelope (the same accept / refuse and
reasons, over the cases of tests/test_staged_cli_routing.py), and
_align_staged / align_point_clouds on a 4,096-point pair with the
reference's defaults (no feature_radius: the AUTO radius, the staged
pyramid).  The one case that differs on purpose: the port accepts the AUTO
radius on any device, the JAX package only with its cell-kernel backend
(LGR_CELL_FPFH=force on the CPU).
"""
import contextlib
import dataclasses
import io
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu import types as jtypes
from lidar_global_registration_tpu.models import flagship as jfl
from lidar_global_registration_tpu.models import pipeline as jpipe
from lidar_global_registration_tpu.ops import downsample as jds
from lidar_global_registration_tpu.utils import config as jconfig
from lidar_global_registration_tpu_torch import types as ttypes
from lidar_global_registration_tpu_torch.models import flagship as tfl
from lidar_global_registration_tpu_torch.models import pipeline as tpipe
from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error
from lidar_global_registration_tpu_torch.utils import config as tconfig
from test_torch_analysis import max_bucket
from test_torch_e2e_pyramid import pair_inputs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _same_record(t, j):
    """Two dataclass records (or None) equal field by field."""
    assert (t is None) == (j is None)
    if t is None:
        return
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b and type(a) is type(b), f.name


def test_constants_equal_jax():
    """The port's copy of the ids and defaults (types.py:29-86)."""
    names = [n for n in dir(jtypes) if n.isupper() and not n.startswith("_")]
    assert len(names) == 50
    for n in names:
        assert getattr(ttypes, n) == getattr(jtypes, n), n
    _same_record(ttypes.AlignmentParameters(), jtypes.AlignmentParameters())
    assert ttypes.Cloud.PAD_COORD == jtypes.Cloud.PAD_COORD


SWEEPS = {
    # tests/test_config_naming.py
    "cartesian": ({"descriptor": ["fpfh", "shot"],
                   "metric": ["correspondences", "uniformity", "combination"],
                   "lrf": "gravity", "scale": [1.5, 2.0]}, 0.1, 0.2, False),
    "defaults": ({}, 0.1, 0.25, True),
    "overrides": ({"distance_thr": 0.7, "iss_radius": 0.3, "feature_radius": 0.5, "bf": False},
                  0.1, 0.2, False),
    # every key expand_parameters reads
    "all_keys": ({"edge_thr": 0.9, "iteration": 1000, "confidence": 0.99, "randomness": 2,
                  "n_samples": 4, "save_features": True, "block_size": 500,
                  "hypothesis_batch": 1024, "bf16_matching": True,
                  "alignment": ["ransac", "gror"], "keypoint": ["iss", "any"],
                  "distance_thr": [0.5, 1.0], "feature_radius": [0, 2.5], "feature_nr": 300,
                  "normal_nr": 20, "reestimate": False, "iss_radius": [0.3, 0.4],
                  "descriptor": "fpfh", "lrf": "default", "metric": "correspondences",
                  "matching": ["cluster", "lr"], "weight": "harris", "score": "mae",
                  "scale": 1.5, "cluster_k": 30}, 0.2, 0.1, False),
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_expand_parameters_matches_jax(case):
    node, ds, dt, normals = SWEEPS[case]
    vp = np.array([1.0, 2.0, 3.0], np.float32)
    want = jconfig.expand_parameters(jconfig.Config(dict(node)), ds, dt, normals, vp, -vp)
    got = tconfig.expand_parameters(tconfig.Config(dict(node)), ds, dt, normals, vp, -vp)
    assert len(got) == len(want) >= 1
    for t, j in zip(got, want):
        _same_record(t, j)
    if case == "defaults":
        assert got[0].feature_radius is None and got[0].descriptor_id == "shot"
    if case == "all_keys":
        assert len(got) == 2 ** 6 and got[-1].replace(seed=3).seed == 3


def test_config_wrapper():
    c = tconfig.Config({"a": 1, "b": [1, 2], "c": None,
                        "tests": [{"test": {"x": 1}}, {"measure": {"y": 2}}]})
    assert c.get("a") == 1 and c.get("c", 5) == 5 and c.get("zz") is None
    assert c.get_vector("a") == [1] and c.get_vector("b") == [1, 2]
    assert c.get_vector("c") is None and c.get_vector("c", 7) == [7]
    assert [(k, t.node) for k, t in c.tests()] == [("test", {"x": 1}), ("measure", {"y": 2})]
    assert tconfig.Config({}).tests() is None
    c.set("a", 2)
    assert c.get("a") == 2


def _params(types, **kw):
    base = dict(alignment_id="ransac", descriptor_id="fpfh", keypoint_id="any",
                matching_id="lr", metric_id="correspondences", lrf_id="default",
                feature_radius=3.0, distance_thr=1.0, iss_radius_src=0.5, iss_radius_tgt=0.5)
    base.update(kw)
    return types.AlignmentParameters(**base)


ENVELOPE = {
    # tests/test_staged_cli_routing.py:35-80
    "dense_fpfh": dict(),
    "shipped_shot": dict(keypoint_id="iss", matching_id="cluster", descriptor_id="shot",
                         lrf_id="gravity", metric_id="uniformity"),
    "gror": dict(alignment_id="gror", keypoint_id="iss", matching_id="cluster"),
    "sweep_fields": dict(keypoint_id="iss", matching_id="cluster", scale_factor=1.5,
                         randomness=2, cluster_k=30, n_samples=4, edge_thr_coef=0.9,
                         confidence=0.99, hypothesis_batch=1024),
    "rops": dict(descriptor_id="rops"),
    "one_sided": dict(matching_id="one_sided"),
    "closest_plane": dict(metric_id="closest_plane"),
    "teaser": dict(alignment_id="teaser"),
    "save_features": dict(save_features=True),
    "file_normals": dict(normals_available=True),
    "guess": dict(guess=np.eye(4, dtype=np.float32)),
    "feature_nr": dict(feature_nr_points=99),
    "normal_nr": dict(normal_nr_points=99),
    "reestimate": dict(reestimate_frames=False),
    "any_cluster": dict(matching_id="cluster"),
    "shot_gt_lrf": dict(descriptor_id="shot", lrf_id="gt"),
    "harris_keypoint": dict(keypoint_id="harris"),
    # AUTO radius outside iss + cluster: refused by both
    "auto_any": dict(feature_radius=None),
    "auto_iss_lr": dict(feature_radius=None, keypoint_id="iss"),
}


@pytest.mark.parametrize("case", sorted(ENVELOPE))
def test_staged_envelope_matches_jax(case):
    """The same verdict and reason, and field for field the same config."""
    jcfg, jreason = jpipe.staged_envelope(_params(jtypes, **ENVELOPE[case]))
    tcfg, treason = tpipe.staged_envelope(_params(ttypes, **ENVELOPE[case]))
    assert treason == jreason
    assert (tcfg is None) == (jcfg is None) == bool(jreason)
    if tcfg is not None:
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def test_envelope_auto_radius_is_the_pyramid(monkeypatch):
    """feature_radius None with iss + cluster: the JAX package refuses it
    off its cell-kernel backend and accepts it with the cells forced; the
    port accepts it on any device, with the same config."""
    kw = dict(feature_radius=None, keypoint_id="iss", matching_id="cluster")
    monkeypatch.delenv("LGR_CELL_FPFH", raising=False)
    jcfg, jreason = jpipe.staged_envelope(_params(jtypes, **kw))
    assert jcfg is None and "pyramid" in jreason
    monkeypatch.setenv("LGR_CELL_FPFH", "force")
    jcfg, _ = jpipe.staged_envelope(_params(jtypes, **kw))
    tcfg, treason = tpipe.staged_envelope(_params(ttypes, **kw))
    assert treason == "" and tcfg.pyramid and jcfg.pyramid
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def test_reference_defaults_reach_the_pyramid():
    """A config that names nothing but the shipped gravity frames: ISS,
    SHOT, cluster matching, uniformity, the AUTO radius -> pyramid=True."""
    (p,) = tconfig.expand_parameters(tconfig.Config({"lrf": "gravity"}), 0.1, 0.1, False)
    cfg, reason = tpipe.staged_envelope(p)
    assert reason == ""
    assert (cfg.pyramid, cfg.descriptor, cfg.lrf, cfg.cluster_matching, cfg.metric, cfg.rounds,
            cfg.use_iss, cfg.alignment) == (True, "shot", "gravity", True, "uniformity", 64,
                                            True, "ransac")
    (p,) = tconfig.expand_parameters(tconfig.Config({}), 0.1, 0.1, False)
    assert tpipe.staged_envelope(p)[0].lrf == "default"


# ---------------------------------------------------------------------------
# _align_staged / align_point_clouds
# ---------------------------------------------------------------------------
DENSITY = 0.15


@pytest.fixture(scope="module")
def aligned():
    """The graded pair of tests/test_torch_e2e_pyramid.py through both
    packages' align_point_clouds with the reference's defaults (+ gravity
    frames), unequal capacities, and a spy on register_pair_staged."""
    a, b, vp_a, vp_b, T_gt = pair_inputs()
    node = {"lrf": "gravity", "hypothesis_batch": 1024}
    out = {"T_gt": T_gt, "a": a, "b": b}
    for name, types, config, pipe, fl in (("jax", jtypes, jconfig, jpipe, jfl),
                                          ("port", ttypes, tconfig, tpipe, tfl)):
        (p,) = config.expand_parameters(config.Config(dict(node)), DENSITY, DENSITY, False,
                                        vp_a, vp_b)
        src = types.Cloud.from_numpy(a)
        tgt = types.Cloud.from_numpy(b, capacity=4224)
        calls = []
        orig = fl.register_pair_staged
        log = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(log):
            mp.setenv("LGR_CELL_FPFH", "force")
            target = pipe if name == "port" else fl  # the port binds the name at import
            mp.setattr(target, "register_pair_staged",
                       lambda *args, _o=orig, **kw: (calls.append((args, kw)), _o(*args, **kw))[1])
            kw = dict(device="cpu") if name == "port" else {}
            res = pipe.align_point_clouds(src, tgt, p, save_artifacts=False,
                                          density_src=DENSITY, density_tgt=DENSITY, **kw)
        out[name] = dict(res=res, calls=calls, log=log.getvalue(), params=p)
    return out


def test_align_staged_radii_equal_jax(aligned):
    (jargs, jkw), = aligned["jax"]["calls"]
    (targs, tkw), = aligned["port"]["calls"]
    # normal_cell, densities, ISS radii, the AUTO feature radius, distance_thr
    assert [float(v) for v in targs[5:12]] == [float(v) for v in jargs[5:12]]
    assert targs[10] == pytest.approx(np.sqrt(352 * DENSITY ** 2 / np.pi))
    assert tkw["cfg"].pyramid and jkw["cfg"].pyramid and tkw["return_correspondences"]
    for f in dataclasses.fields(tkw["cfg"]):
        assert getattr(tkw["cfg"], f.name) == getattr(jkw["cfg"], f.name), f.name
    # both sides padded to one capacity with PAD_COORD, invalid
    for x, v in ((targs[0], targs[1]), (targs[2], targs[3])):
        assert x.shape == (4224, 3) and int(v.sum()) == 4096
        assert bool((x[~v] == ttypes.Cloud.PAD_COORD).all())
    np.testing.assert_array_equal(tkw["vp_src"].numpy(), np.asarray(jkw["vp_src"]))
    np.testing.assert_array_equal(tkw["vp_tgt"].numpy(), np.asarray(jkw["vp_tgt"]))


def test_align_staged_results(aligned):
    thr = aligned["port"]["params"].distance_thr
    assert thr == pytest.approx(4 * DENSITY)
    for name in ("jax", "port"):
        res = aligned[name]["res"]
        assert "->" not in aligned[name]["log"], aligned[name]["log"]  # no gate notice
        r, t = rotation_translation_error(torch.as_tensor(np.array(res.transformation)),
                                          torch.from_numpy(aligned["T_gt"]))
        assert res.converged and float(r) < 0.05 and float(t) < thr, (name, float(r), float(t))
        assert res.transformation.dtype == np.float32 and res.transformation.shape == (4, 4)
        assert res.time_cs == 0.0 and res.time_te > 0 and res.iterations > 0
        assert 0.3 < res.metric <= 1.0
    res = aligned["port"]["res"]
    assert isinstance(res, ttypes.AlignmentResult) and isinstance(res.src, ttypes.Cloud)
    c = res.correspondences
    ok = c.valid.numpy()
    assert ok.sum() > 10 and c.capacity == ok.size
    q, m = c.query.numpy()[ok], c.match.numpy()[ok]
    assert q.min() >= 0 and q.max() < 4096 and m.min() >= 0 and m.max() < 4096
    th = c.threshold.numpy()[ok]
    assert (th > 0).all() and (th <= thr + 1e-6).all() and not c.distance.any()
    # the exported pairs are geometrically the same point of the scene
    moved = aligned["a"][q] @ aligned["T_gt"][:3, :3].T + aligned["T_gt"][:3, 3]
    assert np.mean(np.linalg.norm(moved - aligned["b"][m], axis=1) < thr) > 0.3
    nj = int(np.asarray(aligned["jax"]["res"].correspondences.valid).sum())
    assert abs(int(ok.sum()) - nj) <= 0.2 * nj


def _tiny_clouds():
    x = np.random.default_rng(0).uniform(0, 5, size=(200, 3)).astype(np.float32)
    return ttypes.Cloud.from_numpy(x), ttypes.Cloud.from_numpy(x.copy())


def _patch_clouds():
    """900 points on a 3 x 3 bump patch 2 above the origin, the default
    viewpoint, which so orients every normal (a surface: the descriptors of
    the random blob above hang on normals that float32 rounding orients)."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 3, (900, 2))
    z = 2.0 + 0.3 * np.sin(2.1 * xy[:, 0]) * np.cos(1.7 * xy[:, 1]) + 0.005 * rng.normal(size=900)
    x = np.column_stack([xy, z]).astype(np.float32)
    return ttypes.Cloud.from_numpy(x), ttypes.Cloud.from_numpy(x.copy())


@pytest.mark.parametrize("case,item", [
    (dict(descriptor_id="rops"), "Host-path ops"),
    (dict(descriptor_id="usc"), "Host-path ops"),
    (dict(descriptor_id="shot", lrf_id="gt"), "Host-path ops"),
    # a radius that holds a few keypoints: at the default 0 the JAX package's
    # grid of 1e-12 cells overflows into one bucket of 32 points
    (dict(guess=np.eye(4, dtype=np.float32), match_search_radius=0.5), "Host-path ops"),
    (dict(save_features=True), "item 2"),
])
def test_outside_the_envelope_raises(case, item, capsys, tmp_path, monkeypatch):
    """(Named when the port refused these.)  Outside the staged envelope
    both packages print the reason and take the host pyramid.  The settings
    the port refused before it ported them (ROADMAP Queue 1 item 3,
    'Host-path ops': the RoPS and USC descriptors, SHOT with ground-truth
    frames, an initial guess; item 2: save_features) run in both packages:
    on a cloud and its copy each finds the identity (within 1e-4 rad and
    1e-4), from the same correspondences, every one a row and itself (on
    the patch the two sets differ by at most 1 %: measured, 1 of ~900
    rows, whose mutual match a near-equal neighbour's descriptor decides).  With
    save_features each package writes the level's descriptors
    (histograms_src / _tgt.csv at a fixed radius): the same index column,
    the values within the host FPFH tolerance of
    tests/test_torch_host_ops.py::test_fpfh_matches_jax (0.15 at most, 0.005
    on average, of 100 a block), on a surface patch (_patch_clouds), at
    every row: a voxel of one point is JAX's own row
    (tests/test_torch_downsample.py::test_lone_voxel_is_the_jax_row)."""
    src, tgt = _patch_clouds() if case.get("save_features") else _tiny_clouds()
    _cfg, reason = tpipe.staged_envelope(_params(ttypes, **case))
    line = f"# staged TPU path unavailable ({reason}); host pyramid path used"
    assert item in ("Host-path ops", "item 2")
    features = {}
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        if name == "port":
            res = tpipe.align_point_clouds(src, tgt, _params(ttypes, **case),
                                           save_artifacts=False, device="cpu")
        else:
            x = src.xyz.numpy()[src.valid.numpy()]  # the points, not the padding rows
            jres = jpipe.align_point_clouds(jtypes.Cloud.from_numpy(x),
                                            jtypes.Cloud.from_numpy(x.copy()),
                                            _params(jtypes, **case), save_artifacts=False)
        features[name] = {p.name: np.loadtxt(p, delimiter=",", ndmin=2)
                          for p in (tmp_path / name).rglob("*.csv")}
    if case.get("save_features"):
        assert sorted(features["port"]) == sorted(features["jax"])
        assert [n.split("_352_")[0] for n in sorted(features["port"])] == [
            "_histograms_src", "_histograms_tgt"]
        # the level's surface (radius 2 = 2^floor(log2 3), voxel sqrt(pi 2^2 / 352)):
        # under JAX's FPFH caps (128 points a cell, 384 neighbours)
        x = src.xyz.numpy()[src.valid.numpy()]
        voxel = float(np.sqrt(np.pi * 4.0 / 352))
        js = jds.voxel_downsample(jtypes.Cloud.from_numpy(x), voxel)
        sj = np.asarray(js.xyz)[np.asarray(js.valid)]
        assert max_bucket(sj, 2.0) <= 128
        assert (((sj[None] - sj[:, None]) ** 2).sum(-1) <= 4.0).sum(1).max() <= 384
        for name, t in features["port"].items():
            j = features["jax"][name]
            assert t.shape == j.shape and t.shape[0] > 20 and t.shape[1] == 34
            np.testing.assert_array_equal(t[:, 0], j[:, 0])
            diff = np.abs(t[:, 1:] - j[:, 1:])
            assert diff.max() < 0.15 and diff.mean() < 0.005, (diff.max(), diff.mean())
    else:
        assert not features["port"] and not features["jax"]
    assert reason and capsys.readouterr().out.count(line) == 2
    pairs = []
    for r in (res, jres):
        assert r.converged
        rerr, terr = rotation_translation_error(torch.as_tensor(np.asarray(r.transformation)),
                                                torch.eye(4))
        assert float(rerr) < 1e-4 and float(terr) < 1e-4, (float(rerr), float(terr))
        v = np.asarray(r.correspondences.valid)
        q, m = np.asarray(r.correspondences.query)[v], np.asarray(r.correspondences.match)[v]
        assert len(q) > 20 and (q == m).all()
        pairs.append(set(q.tolist()))
    if case.get("save_features"):  # the patch: near-equal neighbours' descriptors
        assert len(pairs[0] ^ pairs[1]) <= 0.01 * len(pairs[1]), pairs[0] ^ pairs[1]
    else:
        assert pairs[0] == pairs[1]


def test_teaser_raises_after_the_search(capsys):
    """alignment teaser: the search runs, then the JAX package's refusal."""
    src, tgt = _tiny_clouds()
    with pytest.raises(NotImplementedError, match="support TEASER"):
        tpipe.align_point_clouds(src, tgt, _params(ttypes, alignment_id="teaser"),
                                 save_artifacts=False, device="cpu")
    assert "host pyramid path used" in capsys.readouterr().out


def test_preloaded_correspondences_and_artifacts_raise(tmp_path, monkeypatch):
    """Pre-loaded correspondences go to the solver with no search, as in
    the JAX package: on the same set (60 pairs of one cloud and its copy,
    so every pair is an inlier) both packages converge to the identity in
    one round; with save_artifacts the correspondence cache and the
    transformations.csv rows (the GT's, then the estimate's) are written
    under the JAX package's names."""
    from lidar_global_registration_tpu.utils import naming as jnaming

    src, tgt = _tiny_clouds()
    n, cap = 60, 128
    q = np.zeros(cap, np.int64)
    q[:n] = np.arange(0, 3 * n, 3)
    thr = np.full(cap, 0.05, np.float32)
    valid = np.arange(cap) < n
    corr = ttypes.Correspondences(torch.from_numpy(q), torch.from_numpy(q),
                                  torch.zeros(cap), torch.from_numpy(thr),
                                  torch.from_numpy(valid))
    jcorr = jtypes.Correspondences(*(jnp.asarray(v) for v in (q.astype(np.int32),
                                                              q.astype(np.int32),
                                                              np.zeros(cap, np.float32), thr,
                                                              valid)))
    x = src.xyz.numpy()[:200]
    jres = jpipe.align_point_clouds(jtypes.Cloud.from_numpy(x), jtypes.Cloud.from_numpy(x),
                                    _params(jtypes), save_artifacts=False, correspondences=jcorr)
    tres = tpipe.align_point_clouds(src, tgt, _params(ttypes), save_artifacts=False,
                                    correspondences=corr, device="cpu")
    assert tres.converged and jres.converged and tres.time_cs == jres.time_cs == 0.0
    assert tres.iterations == jres.iterations
    np.testing.assert_allclose(tres.transformation, np.asarray(jres.transformation), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tres.transformation, np.eye(4), rtol=0, atol=1e-5)
    assert int(tres.correspondences.count()) == n
    monkeypatch.chdir(tmp_path)
    gt = np.eye(4, dtype=np.float32)
    kw = dict(testname="a_b", ground_truth=gt)
    res = tpipe.align_point_clouds(src, tgt, _params(ttypes, **kw), device="cpu")
    jp = _params(jtypes, **kw)
    cache = Path(jnaming.construct_path(jp, "correspondences", "csv", True, False, False))
    lines = cache.read_text().splitlines()
    assert lines[0] == "query_idx,match_idx,distance,threshold,x_s,y_s,z_s,x_t,y_t,z_t"
    assert len(lines) == 1 + int(res.correspondences.valid.sum())
    rows = (tmp_path / "data/debug/transformations.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == [
        "reading", jnaming.construct_name(jp, "transformation_gt"),
        jnaming.construct_name(jp, "transformation")]
    np.testing.assert_allclose(np.array(rows[2].split(",")[1:], float),
                               res.transformation.reshape(-1), rtol=1e-5, atol=1e-5)


def test_cloud_from_numpy():
    x = np.arange(15, dtype=np.float64).reshape(5, 3)
    jc = jtypes.Cloud.from_numpy(x, normal=x / 10, weight=np.arange(5))
    tc = ttypes.Cloud.from_numpy(x, normal=x / 10, weight=np.arange(5))
    assert tc.capacity == jc.capacity == 128
    for f in ("xyz", "normal", "weight", "curvature", "valid"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    assert ttypes.Cloud.from_numpy(x, capacity=7).capacity == 7
    with pytest.raises(ValueError, match="capacity"):
        ttypes.Cloud.from_numpy(x, capacity=3)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every .py of the port, chip_smoke.py, bench_torch.py,
    tools/datasets_torch.py and tools/bench_sweep_torch.py: no import of jax
    or of lidar_global_registration_tpu (the name without _torch)."""
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|lidar_global_registration_tpu)(?:[.\s]|$)", re.M)
    files = sorted((ROOT / "lidar_global_registration_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
              ROOT / "tools" / "datasets_torch.py", ROOT / "tools" / "bench_sweep_torch.py"]
    assert len(files) > 20
    for f in files:
        assert not pattern.search(f.read_text()), f
    assert pattern.search("from lidar_global_registration_tpu.types import Cloud")
    assert pattern.search("    import jax.numpy as jnp")
    assert not pattern.search("from lidar_global_registration_tpu_torch.types import Cloud")
