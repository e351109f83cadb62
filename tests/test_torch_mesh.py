"""The PyTorch port's ('dp', 'tp') mesh step (parallel/mesh.py,
parallel/batch.py) and the forms it needs, against the port's one-process
step and the JAX package's mesh step.

The mesh runs spawn their ranks as processes of this file (run as a
script, below) on the CPU over gloo, rendezvous through a FileStore under
tmp_path (no TCP port), one thread each: tp = 2 (two processes) and dp = 2
with tp = 2 (four).  Each rank joins with a time limit, and a rank that
dies fails the test at once.  The inputs are JAX's `_args(1024)` pair
(tests/test_flagship_parallel.py) and the same pair with its target turned
by 25 degrees and shifted, the scalars of `_args`, viewpoints at the
origin; the configurations are JAX's test_tp2_matches_single_device (ISS,
FPFH, cluster matching) and the same with use_iss=False (mutual 1-NN).
Each rank's batch must be torch.equal to register_pair_step on every pair;
the JAX package's make_register_batch(make_mesh(8, tp=2)) registers the
same pairs, compared at the pose level.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from lidar_global_registration_tpu_torch.models import flagship as tfl  # noqa: E402
from lidar_global_registration_tpu_torch.ops import cellgrid as cg  # noqa: E402
from lidar_global_registration_tpu_torch.ops import fpfh as tfpfh  # noqa: E402
from lidar_global_registration_tpu_torch.ops.matchers import match_bf  # noqa: E402

torch.set_num_threads(2)

N = 1024
SEEDS = (566, 567)
CONFIGS = {"iss": dict(rounds=4, hypothesis_batch=256, use_iss=True),  # JAX's tp = 2 test
           "any": dict(rounds=4, hypothesis_batch=256, use_iss=False)}
MESHES = {"tp2": (2, 2), "dp2_tp2": (4, 2)}  # (processes, tp)
RANK_TIMEOUT = 240.0  # seconds for the slowest rank of a mesh run


def _turn(deg: float, shift) -> np.ndarray:
    a = np.deg2rad(deg)
    T = np.eye(4)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    T[:3, 3] = shift
    return T


def _batch():
    """The two pairs (numpy): JAX's _args(1024) pair and its target turned
    by M, with the known poses T_gt."""
    from __graft_entry__ import _synthetic_pair

    a, b = _synthetic_pair(N, seed=566)
    R = _turn(np.rad2deg(0.4), [0, 0, 0])[:3, :3]  # the pair's turn about z, 0.4 rad
    T0 = np.eye(4)
    T0[:3, :3], T0[:3, 3] = R.T, -R.T @ np.array([2.0, -1.0, 0.5])
    M = _turn(25.0, [3.0, 1.0, -0.5])
    b1 = (b @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    spacing = 30.0 / np.sqrt(N)
    row = np.float32([spacing * 4, spacing * 2, spacing * 2, spacing * 3, spacing * 3,
                      spacing * 8, spacing * 4])
    return dict(src=np.stack([a, a]), tgt=np.stack([b, b1]), valid=np.ones((2, N), bool),
                scalars=np.stack([row, row]), vps=np.zeros((2, 2, 3), np.float32),
                T_gt=np.stack([T0, M @ T0]))


def _tensors(batch):
    return {k: torch.from_numpy(batch[k].copy()) for k in ("src", "tgt", "valid", "scalars",
                                                          "vps")}


def _worker(rank: int, world: int, tp: int, store: str, out: str) -> None:
    """One rank of a mesh run: the batch of both configurations over
    make_mesh(world, tp), saved to out.<rank>."""
    import datetime

    import torch.distributed as dist

    from lidar_global_registration_tpu_torch.parallel.batch import make_register_batch
    from lidar_global_registration_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    t = _tensors(dict(np.load(Path(out).parent / "batch.npz")))
    mesh = make_mesh(world, tp=tp, device_type="cpu")
    res = {}
    for name, kw in CONFIGS.items():
        step = make_register_batch(mesh, tfl.FlagshipConfig(**kw))
        res[name] = step(t["src"], t["valid"], t["tgt"], t["valid"], list(SEEDS), t["scalars"],
                         t["vps"])
    torch.save(res, f"{out}.{rank}")
    dist.destroy_process_group()


def _run_meshes(tmp: Path) -> dict:
    """Every mesh of MESHES at once, each rank a process of this file;
    returns {mesh: [each rank's results]}.  Fails when a rank exits non-zero
    or the runs outlast RANK_TIMEOUT, and kills the ranks left."""
    procs = []
    for name, (world, tp) in MESHES.items():
        for rank in range(world):
            log = open(tmp / f"{name}.{rank}.log", "w")
            procs.append((name, rank, log, subprocess.Popen(
                [sys.executable, __file__, str(rank), str(world), str(tp),
                 str(tmp / f"{name}.store"), str(tmp / name)],
                stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT))))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while any(p.poll() is None for *_x, p in procs):
            dead = [(n, r) for n, r, _l, p in procs if p.poll() not in (None, 0)]
            assert not dead, f"ranks died: {dead}: " + " | ".join(
                (tmp / f"{n}.{r}.log").read_text()[-2000:] for n, r in dead)
            assert time.monotonic() < deadline, "a mesh run outlasted its time limit"
            time.sleep(0.1)
        dead = [(n, r) for n, r, _l, p in procs if p.returncode != 0]
        assert not dead, f"ranks failed: {dead}"
    finally:
        for *_x, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return {name: [torch.load(tmp / f"{name}.{r}") for r in range(world)]
            for name, (world, _tp) in MESHES.items()}


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def meshes(batch, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    np.savez(tmp / "batch.npz", **{k: v for k, v in batch.items() if k != "T_gt"})
    return _run_meshes(tmp)


@pytest.fixture(scope="module")
def steps(batch):
    """register_pair_step of each configuration on each pair, one process."""
    t = _tensors(batch)
    out = {}
    for name, kw in CONFIGS.items():
        out[name] = [tfl.register_pair_step(
            t["src"][i], t["valid"][i], t["tgt"][i], t["valid"][i],
            torch.Generator().manual_seed(seed), *t["scalars"][i].tolist(),
            vp_src=t["vps"][i, 0], vp_tgt=t["vps"][i, 1], cfg=tfl.FlagshipConfig(**kw))
            for i, seed in enumerate(SEEDS)]
    return out


@pytest.fixture(scope="module")
def jax_mesh(batch):
    """JAX's make_register_batch(make_mesh(8, tp=2)) with the ISS
    configuration: dp = 4, so the two pairs twice."""
    import jax
    import jax.numpy as jnp

    from lidar_global_registration_tpu.models.flagship import FlagshipConfig
    from lidar_global_registration_tpu.parallel.batch import make_register_batch
    from lidar_global_registration_tpu.parallel.mesh import make_mesh, pair_sharding

    mesh = make_mesh(8, tp=2)
    put = lambda x: jax.device_put(jnp.asarray(np.concatenate([x, x])),  # noqa: E731
                                   pair_sharding(mesh))
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in SEEDS])
    T, inl, nc = make_register_batch(mesh, FlagshipConfig(**CONFIGS["iss"]))(
        put(batch["src"]), put(batch["valid"]), put(batch["tgt"]), put(batch["valid"]),
        put(keys), put(batch["scalars"]), put(batch["vps"]))
    return np.asarray(T), np.asarray(inl), np.asarray(nc)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_mesh_batch_equals_the_step(meshes, steps, mesh_name, cfg_name):
    """Every rank returns the whole batch, and each pair's (T, inliers,
    n_correspondences) is torch.equal to register_pair_step's on that pair
    and seed: the rows split over tp and the pairs over dp re-tile the same
    arithmetic."""
    ranks = meshes[mesh_name]
    T, inl, nc = ranks[0][cfg_name]
    assert T.shape == (2, 4, 4) and inl.shape == nc.shape == (2,)
    for other in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(other[cfg_name], (T, inl, nc)))
    for i, o in enumerate(steps[cfg_name]):
        assert torch.equal(T[i], o["transformation"]), (mesh_name, cfg_name, i)
        assert torch.equal(inl[i], o["inliers"]) and torch.equal(nc[i], o["n_correspondences"])


def test_mesh_matches_jax_mesh_poses(batch, meshes, jax_mesh):
    """The port's tp = 2 batch and JAX's mesh step (dp = 4, tp = 2) with
    the ISS configuration each find both pairs' known poses under bench.py's
    rule (within 0.05 rad and distance_thr, at least 10 inliers), and their
    rotations agree within 0.05 rad (tests/test_torch_step.py's
    test_step_iss_matches_jax)."""
    from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error

    def err(A, B):
        r, t = rotation_translation_error(torch.as_tensor(np.asarray(A, np.float64)),
                                          torch.as_tensor(np.asarray(B, np.float64)))
        return float(r), float(t)

    jT, jinl, _jnc = jax_mesh
    T, inl, _nc = meshes["tp2"][0]["iss"]
    for i in range(2):
        thr = float(batch["scalars"][i, 6])
        for name, Ti, n_inl in (("jax", jT[i], jinl[i]), ("jax dp copy", jT[i + 2], jinl[i + 2]),
                                ("port", T[i].numpy(), inl[i])):
            r, t = err(Ti, batch["T_gt"][i])
            assert r < 0.05 and t < thr and int(n_inl) >= 10, (name, i, r, t, int(n_inl))
        assert err(T[i].numpy(), jT[i])[0] < 0.05


@pytest.mark.parametrize("k,offset,exclude", [(1, 0, False), (1, 300, False), (1, 300, True),
                                              (8, 0, True), (8, 300, True)])
def test_match_bf_shard_forms_match_jax(k, offset, exclude):
    """match_bf on a train shard (rows offset.. of the query set) against
    JAX's match_bf(exclude_ids, id_offset): the same local indices and
    masks, squared distances to float32 summation order.  Without exclude_ids the
    k = 1 path is K7's (its plain version here)."""
    import jax.numpy as jnp

    from lidar_global_registration_tpu.ops.matchers import match_bf as jax_match_bf

    rng = np.random.default_rng(566)
    q = rng.normal(size=(600, 3 if exclude else 33)).astype(np.float32)
    qv = rng.uniform(size=600) > 0.1
    shard = slice(offset, offset + 300)
    ids = np.arange(600, dtype=np.int32) if exclude else None
    ji, jd, jm = (np.asarray(a) for a in jax_match_bf(
        jnp.asarray(q), jnp.asarray(q[shard]), jnp.asarray(qv), jnp.asarray(qv[shard]), k=k,
        tile=128, exclude_ids=None if ids is None else jnp.asarray(ids), id_offset=offset))
    ti, td, tm = (a.numpy() for a in match_bf(
        torch.from_numpy(q), torch.from_numpy(q[shard]), torch.from_numpy(qv),
        torch.from_numpy(qv[shard]), k=k, tile=128,
        exclude_ids=None if ids is None else torch.from_numpy(ids).long(), id_offset=offset))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(np.where(tm, ti, 0), np.where(jm, ji, 0))
    # Gram-trick d2 = |q|^2 + |t|^2 - 2 q.t in float32, the products summed
    # in another order: a few ulps of |q|^2 (up to ~70 here, ulp 8e-6)
    np.testing.assert_allclose(td[tm] ** 2, jd[jm] ** 2, rtol=0, atol=2e-4)
    if exclude:  # no query holds itself
        assert not (ti + offset == np.arange(600)[:, None])[tm].any()


def _iss_cloud():
    g = torch.Generator().manual_seed(566)
    x = torch.rand(6000, 3, generator=g) * torch.tensor([4.0, 4.0, 0.5])
    valid = torch.ones(6000, dtype=torch.bool)
    valid[::17] = False
    return x, valid, g


@pytest.mark.parametrize("which", ["half0", "half1", "random", "one", "none"])
def test_iss_slot_forms_equal_the_full_passes(monkeypatch, which):
    """K2-K4's slot-list plain forms at a list of slots (each input half's,
    a shuffled third, one slot, none) return the full passes' rows at those
    slots, torch.equal, on a plan whose full passes run in many chunks (K3
    pads each slot's candidates to its full-pass chunk's width)."""
    monkeypatch.setattr(cg, "_CHUNK_PAIRS", 1 << 14)
    x, valid, g = _iss_cloud()
    r = 0.25
    plan = cg.plan_grid(x, valid, r)
    assert len(cg._query_chunks(plan)) > 10
    r2 = cg._f32_square(r)
    count, inv = cg.iss_count_plain(plan, r2)
    sal, ok, nb = cg.iss_saliency_plain(plan, r2, inv, 0.975, 0.975)
    kp = cg.iss_nms_plain(plan, r2, sal, ok, 4)
    assert 0 < int(kp.sum()) < int(ok.sum())
    slot = cg.slot_of(plan)
    slots = {"half0": slot[:3000][slot[:3000] >= 0], "half1": slot[3000:][slot[3000:] >= 0],
             "random": torch.randperm(plan.n_valid, generator=g)[:2000],
             "one": torch.tensor([plan.n_valid // 2]),
             "none": torch.zeros((0,), dtype=torch.int64)}[which]
    c2, i2 = cg.iss_count_at(plan, r2, slots)
    s2, o2, n2 = cg.iss_saliency_at(plan, r2, inv, 0.975, 0.975, slots)
    k2 = cg.iss_nms_at(plan, r2, sal, ok[slots], 4, slots)
    for got, want in ((c2, count), (i2, inv), (s2, sal), (o2, ok), (n2, nb), (k2, kp)):
        assert torch.equal(got, want[slots])


def _peers(tp: int, fn):
    """fn(rows, gather) on tp threads, one a tp peer: rows its shard of
    _iss_cloud's 6,000 rows (as the tp step splits them), gather the peers'
    values concatenated in rank order (barrier-synchronised, as
    parallel/mesh.gather_rows).  Returns each peer's result; a peer that
    raises fails the call (the others' barrier breaks, no hang)."""
    import threading

    bar = threading.Barrier(tp, timeout=60)
    box, out, err = [None] * tp, [None] * tp, []
    shard = 6000 // tp

    def run(ti):
        def gather(x):
            box[ti] = x
            bar.wait()
            whole = torch.cat(box)
            bar.wait()
            return whole
        try:
            out[ti] = fn(slice(ti * shard, (ti + 1) * shard), gather)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            err.append(e)
            bar.abort()

    threads = [threading.Thread(target=run, args=(ti,)) for ti in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads), "a peer hung"
    if err:
        raise err[0]
    return out


@pytest.mark.parametrize("tp", [1, 2, 3])
def test_iss_pass_at_rows_equals_the_full_pass(monkeypatch, tp):
    """cellgrid.iss_pass at each peer's rows (K2-K4's slot-list forms, each
    pass reading the gathered result of the one before) returns on every
    peer the full pass's keypoints and saliency, torch.equal, on a plan of
    many chunks."""
    monkeypatch.setattr(cg, "_CHUNK_PAIRS", 1 << 14)
    x, valid, _g = _iss_cloud()
    plan = cg.plan_grid(x, valid, 0.25)
    kp, sal = cg.iss_pass(plan, 0.25)
    assert 0 < int(kp.sum()) < int(valid.sum())
    for got in _peers(tp, lambda rows, gather: cg.iss_pass(plan, 0.25, rows=rows,
                                                           gather=gather)):
        assert torch.equal(got[0], kp) and torch.equal(got[1], sal)


@pytest.mark.parametrize("use_iss", [True, False])
@pytest.mark.parametrize("tp", [2, 3])
def test_side_stage_at_rows_equals_the_full_stage(tp, use_iss):
    """flagship._side_stage at each peer's rows (its neighbour lists
    widened to the peers' widest, the density's smoothing neighbour read
    from the gathered distances, ISS through iss_pass at the rows) returns
    on every peer the one-process stage's normals, keypoints and density,
    torch.equal."""
    x, valid, _g = _iss_cloud()
    cfg = tfl.FlagshipConfig(use_iss=use_iss)
    vp = torch.tensor([2.0, 2.0, 5.0])
    want = tfl._side_stage(x, valid, 0.15, 0.25, cfg, vp)
    for got in _peers(tp, lambda rows, gather: tfl._side_stage(x, valid, 0.15, 0.25, cfg, vp,
                                                               rows=rows, gather=gather)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("offset", [0, 150])
def test_match_bf_k1_ties_go_to_the_lowest_index(offset):
    """On descriptors with many exact ties (small integers), match_bf's
    k = 1 path on a train shard (K7's plain version, the offset added after)
    keeps the nearest row with ties to the lowest index, as JAX's match_bf
    does: the indices equal JAX's and the lowest of each query's nearest."""
    import jax.numpy as jnp

    from lidar_global_registration_tpu.ops.matchers import match_bf as jax_match_bf

    rng = np.random.default_rng(567)
    q = rng.integers(0, 3, size=(300, 4)).astype(np.float32)
    qv = np.ones(300, bool)
    shard = slice(offset, offset + 150)
    ji, _jd, jm = (np.asarray(a) for a in jax_match_bf(
        jnp.asarray(q), jnp.asarray(q[shard]), jnp.asarray(qv), jnp.asarray(qv[shard]), k=1,
        tile=128, id_offset=offset))
    ti, _td, tm = (a.numpy() for a in match_bf(
        torch.from_numpy(q), torch.from_numpy(q[shard]), torch.from_numpy(qv),
        torch.from_numpy(qv[shard]), k=1, tile=128, id_offset=offset))
    d2 = ((q[:, None] - q[None, shard]) ** 2).sum(-1)
    assert ((d2 == d2.min(1, keepdims=True)).sum(1) > 1).sum() > 100  # full of ties
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ti[:, 0], d2.argmin(1))
    np.testing.assert_array_equal(ji, ti)


def test_spfh_at_rows_equals_the_full_table():
    """ops/fpfh.spfh_rows at input rows (K5's slot-list form over their
    slots, invalid rows 0) equals the full pass's table at those rows."""
    x, valid, g = _iss_cloud()
    normal = torch.nn.functional.normalize(torch.randn(6000, 3, generator=g), dim=1)
    plan = tfpfh.surface_plan(x, valid, normal, 0.3)
    full = tfpfh.spfh_rows(plan, 0.3)
    for rows in (torch.arange(0, 3000), torch.arange(3000, 6000), torch.tensor([17, 5, 17])):
        assert torch.equal(tfpfh.spfh_rows(plan, 0.3, rows), full[rows])
    assert float(full[~valid].abs().sum()) == 0.0 and float(full[valid].sum()) > 0


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    os._exit(0)
