"""K8 (csrc/knn_xyz.cu, ops/nn_l2.knn_xyz_cuda): the exact k-NN of xyz rows
that matchers.match_bf sends to the card, the cluster gate's keypoint k-NN.

On the CPU: which match_bf calls take the kernel's route, and what
match_bf hands the wrapper and reads back.  On the card
(`card` marker; they skip without one): the kernel against its plain
version, matchers._topk_l2, on the same card, with the tolerances of
tests/test_torch_cluster.py (masks equal, d2 within 5e-4, neighbour sets
equal where the k-th and (k+1)-th distances are more than 1e-3 apart), and
ties to the lowest index.  On the card:

    python -m pytest tests/test_torch_knn_xyz.py -m card --noconftest

(--noconftest: tests/conftest.py sets up JAX, which this file never needs.)
chip_smoke.py runs these card cases, and holds K8 at the benchmark cells'
keypoint shapes to the same contract through `against_plain`.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lidar_global_registration_tpu_torch.ops import matchers, nn_l2
from lidar_global_registration_tpu_torch.ops.nn_l2 import BIG, TILE

T = torch.from_numpy


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: this test runs on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _keypoints(rng, n: int, n_valid: int, extent: float = 40.0):
    """Keypoint-like rows on a terrain of `extent` m a side, centred, in the
    working cloud's z-major order, with a padded tail past n_valid."""
    xy = rng.uniform(-extent / 2, extent / 2, size=(n, 2))
    z = 0.5 * np.sin(0.3 * xy[:, 0]) + 0.2 * rng.normal(size=n)
    p = np.column_stack([xy, z]).astype(np.float32)
    p[:n_valid] = p[:n_valid][np.lexsort((p[:n_valid, 0], p[:n_valid, 1],
                                          np.floor(p[:n_valid, 2] / 0.05)))]
    return p, np.arange(n) < n_valid


# ---------------------------------------------------------------------------
# CPU: the route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("is_cuda, width, k, bf16, routed", [
    (True, 3, 40, False, True),     # the cluster gate's keypoint kNN
    (True, 3, 1, False, True),
    (True, 3, 64, False, True),
    (True, 3, 65, False, False),    # beyond the longest list
    (True, 33, 40, False, False),   # descriptors: the pyramid's vote
    (True, 352, 2, False, False),
    (True, 3, 40, True, False),     # the bf16 matcher
    (False, 3, 40, False, False),   # the CPU
])
def test_route_predicate(is_cuda, width, k, bf16, routed):
    query = SimpleNamespace(is_cuda=is_cuda, shape=(1000, width))
    assert nn_l2.takes_knn_xyz(query, k, bf16) is routed


def test_cpu_match_bf_stays_plain(monkeypatch, rng):
    """On the CPU every k-NN runs _topk_l2, never the kernel's wrapper."""
    def refuse(*_a, **_k):
        raise AssertionError("K8's wrapper called on the CPU")

    monkeypatch.setattr(matchers, "knn_xyz_cuda", refuse)
    p, v = _keypoints(rng, 300, 280)
    idx, dist, mask = matchers.match_bf(T(p), T(p), T(v), T(v), k=8, exclude_diag=True)
    assert mask.shape == (300, 8) and bool(mask[v].all()) and not bool(mask[~v].any())


@pytest.mark.parametrize("call", ["diag", "shard", "plain_k", "k1"])
def test_match_bf_sends_routed_calls_to_the_wrapper(monkeypatch, rng, call):
    """With the route open, match_bf hands the wrapper the call's exclusion
    as given and reads its (d2, index) as it reads _topk_l2's; k = 1
    without exclusion stays on K7."""
    calls = []

    def fake(query, train, qvalid, tvalid, k, exclude_ids, id_offset, exclude_diag):
        calls.append((exclude_ids, id_offset, exclude_diag))
        ids = torch.arange(query.shape[0]) if exclude_diag else exclude_ids
        return matchers._topk_l2(query, train, tvalid, k, ids, id_offset)

    monkeypatch.setattr(matchers, "takes_knn_xyz", lambda q, k, bf16=False: True)
    monkeypatch.setattr(matchers, "knn_xyz_cuda", fake)
    p, v = _keypoints(rng, 400, 370)
    q, qv = T(p), T(v)
    if call == "diag":
        kw, args, k = dict(exclude_diag=True), (q, q, qv, qv), 12
        want = (None, 0, True)
    elif call == "shard":
        ex = torch.arange(400)
        kw, args, k = dict(exclude_ids=ex, id_offset=200), (q, q[200:], qv, qv[200:]), 12
        want = (ex, 200, False)
    elif call == "plain_k":
        kw, args, k = {}, (q[:100], q, qv[:100], qv), 5
        want = (None, 0, False)
    else:
        kw, args, k = {}, (q[:100], q, qv[:100], qv), 1
        want = None
    got = matchers.match_bf(*args, k=k, **kw)
    monkeypatch.undo()
    ref = matchers.match_bf(*args, k=k, **kw)
    if want is None:
        assert calls == []
    else:
        (ex, off, diag), = calls
        assert ex is want[0] and (off, diag) == want[1:]
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [0, 65])
def test_wrapper_refuses_k_outside_its_lists(k):
    with pytest.raises(ValueError):
        nn_l2.knn_xyz_cuda(torch.zeros((4, 3)), torch.zeros((4, 3)), torch.ones(4, dtype=bool),
                           torch.ones(4, dtype=bool), k, exclude_diag=True)


# ---------------------------------------------------------------------------
# the card: the kernel against _topk_l2 on the same card
# ---------------------------------------------------------------------------
def against_plain(q, t, qv, tv, k, exclude_ids=None, id_offset=0, exclude_diag=False,
                  tol=5e-4):
    """K8 and _topk_l2 on the same inputs: masks equal, d2 within `tol`
    (Gram-trick float32 d2 summed in another order: |q|^2 up to ~800 m^2
    leaves a few 1e-4), sets equal where the k-th and (k+1)-th plain
    distances are more than 1e-3 apart; lists ascending, ties to the lowest
    index, no invalid or excluded row.  Returns the kernel's (d2, index)
    and the largest d2 difference."""
    before = nn_l2.knn_xyz_cuda.launches
    kd, ki = nn_l2.knn_xyz_cuda(q, t, qv, tv, k, exclude_ids, id_offset, exclude_diag)
    torch.cuda.synchronize()
    assert nn_l2.knn_xyz_cuda.launches == before + 1
    ids = torch.arange(q.shape[0], device=q.device) if exclude_diag else exclude_ids
    pd, pi = matchers._topk_l2(q, t, tv, k + 1, ids, id_offset)
    kmask = (kd < BIG) & qv[:, None]
    pmask = (pd[:, :k] < BIG) & qv[:, None]
    assert torch.equal(kmask, pmask)
    diff = (kd - pd[:, :k]).abs()[pmask]
    err = float(diff.max()) if diff.numel() else 0.0
    assert err <= tol, f"d2 off by {err} (tolerance {tol})"
    # the set is decided where the (k+1)-th is clear of the k-th, or the
    # k-th is already an empty slot
    clear = qv & ((pd[:, k] - pd[:, k - 1] > 1e-3) | (pd[:, k - 1] >= BIG))
    ks = torch.where(kmask, ki, -1)[clear].sort(1).values
    ps = torch.where(pmask, pi[:, :k], -1)[clear].sort(1).values
    assert torch.equal(ks, ps)
    assert int(clear.sum()) > 0.9 * int(qv.sum())
    # ascending by (d2, index)
    assert bool((kd[:, 1:] >= kd[:, :-1]).all())
    tie = (kd[:, 1:] == kd[:, :-1]) & kmask[:, 1:]
    assert bool((ki[:, 1:] > ki[:, :-1])[tie].all())
    # nothing invalid or excluded wins; empty slots hold (BIG, 0)
    assert bool(tv[ki[kmask]].all())
    if ids is not None:
        own = (ids - id_offset)[:, None].expand_as(ki)
        assert not bool((ki == own)[kmask].any())
    assert bool((kd[~(kd < BIG)] == BIG).all()) and not bool(ki[~(kd < BIG)].any())
    # through match_bf: the same rows, euclidean
    idx, dist, mask = matchers.match_bf(q, t, qv, tv, k=k, exclude_ids=exclude_ids,
                                        id_offset=id_offset, exclude_diag=exclude_diag)
    assert torch.equal(mask, kmask) and torch.equal(idx, torch.where(kmask, ki, 0))
    return kd, ki, err


@pytest.mark.card
@pytest.mark.parametrize("n, n_valid", [(1500, 1400), (10240, 9460), (24576, 22385)])
def test_card_sizes_with_padded_tails(card, n, n_valid):
    p, v = _keypoints(np.random.default_rng(n), n, n_valid)
    q, qv = T(p).to(card), T(v).to(card)
    against_plain(q, q, qv, qv, 40, exclude_diag=True)


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 127, 129])
@pytest.mark.parametrize("k", [2, 40, 64])
def test_card_edges_of_a_block(card, n, k):
    """Fewer rows than a block's 32 queries or a tile's 128 rows, and one
    past each tile."""
    p, v = _keypoints(np.random.default_rng(n + k), n, max(n - n // 12, 1))
    q, qv = T(p).to(card), T(v).to(card)
    against_plain(q, q, qv, qv, k, exclude_diag=True)


@pytest.mark.card
@pytest.mark.parametrize("k", [2, 40, 64])
def test_card_k(card, k):
    p, v = _keypoints(np.random.default_rng(k), 10240, 9460)
    q, qv = T(p).to(card), T(v).to(card)
    against_plain(q, q, qv, qv, k, exclude_diag=True)


@pytest.mark.card
def test_card_k_above_the_valid_count(card):
    p, v = _keypoints(np.random.default_rng(3), 512, 30)
    q, qv = T(p).to(card), T(v).to(card)
    kd, _ki, _err = against_plain(q, q, qv, qv, 40, exclude_diag=True)
    assert bool(((kd < BIG).sum(1)[qv] == 29).all())


@pytest.mark.card
def test_card_no_valid_row(card):
    p, _v = _keypoints(np.random.default_rng(4), 700, 700)
    q = T(p).to(card)
    none = torch.zeros(700, dtype=torch.bool, device=card)
    kd, ki = nn_l2.knn_xyz_cuda(q, q, none, none, 40, exclude_diag=True)
    assert bool((kd == BIG).all()) and not bool(ki.any())
    # valid queries against no valid train row
    kd, ki = nn_l2.knn_xyz_cuda(q, q.clone(), torch.ones_like(none), none, 40)
    assert bool((kd == BIG).all()) and not bool(ki.any())


@pytest.mark.card
def test_card_duplicates_go_to_the_lowest_index(card):
    """Every point four times at scattered rows: d2 equal to the bit within
    each group of copies.  At k = 39 the lists end on whole groups (the
    query's 3 other copies + 9 groups) and match the plain version; at
    k = 41 the k-th place cuts a group in two, and the list must keep its
    two lowest rows."""
    rng = np.random.default_rng(5)
    base, _ = _keypoints(rng, 1000, 1000)
    perm = rng.permutation(4000)
    p = np.concatenate([base] * 4)[perm]
    q = T(p).to(card)
    qv = torch.ones(4000, dtype=torch.bool, device=card)
    against_plain(q, q, qv, qv, 39, exclude_diag=True)
    kd, ki = nn_l2.knn_xyz_cuda(q, q, qv, qv, 41, exclude_diag=True)
    src = perm % 1000  # each row's point
    rows_of = np.argsort(src, kind="stable").reshape(1000, 4)  # each point's rows, ascending
    ki_h = ki.cpu().numpy()
    # the query's own copies first (d2 = 0), then whole groups
    assert (src[ki_h[:, :3]] == src[:, None]).all()
    for r in range(4000):
        g = rows_of[src[ki_h[r, -1]]]
        assert src[ki_h[r, -2]] == src[ki_h[r, -1]], r
        assert ki_h[r, -2:].tolist() == [x for x in g if x != r][:2], r
    tie = (kd[:, 1:] == kd[:, :-1])
    assert bool((ki[:, 1:] > ki[:, :-1])[tie].all())


@pytest.mark.card
def test_card_shard_with_exclude_ids_and_offset(card):
    """match_bf_tp's shard form: every query against rows [lo, hi) of the
    set, its own row left out by global id."""
    p, v = _keypoints(np.random.default_rng(6), 4096, 3900)
    q, qv = T(p).to(card), T(v).to(card)
    lo, hi = 2048, 4096
    ids = torch.arange(4096, device=card)
    against_plain(q, q[lo:hi], qv, qv[lo:hi], 40, exclude_ids=ids, id_offset=lo)


@pytest.mark.card
def test_card_tie_at_the_kth_place_across_the_key_order(card):
    """A query at the origin with k - 4 rows inside the unit sphere and
    eight sign-flipped copies of one point on it (d2 equal to the bit): the
    k-th place cuts the eight.  The copies lie in the bounding cube's eight
    octants, far apart in the kernel's key order, and the four of lowest
    index in the octants that order puts last.  The list must hold those
    four."""
    rng = np.random.default_rng(7)
    k, nt = 40, 5003
    t = rng.uniform(-20, 20, size=(nt, 3)).astype(np.float32)
    t *= (5.0 / np.linalg.norm(t, axis=1).clip(1e-3))[:, None].clip(1.0, None)
    signs = np.array([[a, b, c] for a in (1, -1) for b in (1, -1) for c in (1, -1)], np.float32)
    t[:8] = signs * np.array([0.6, 0.48, 0.64], np.float32)  # (+, +, +) first
    near = rng.normal(size=(k - 4, 3)).astype(np.float32)
    t[100:100 + k - 4] = near * (rng.uniform(0.2, 0.9, size=(k - 4, 1))
                                 / np.linalg.norm(near, axis=1, keepdims=True))
    q = torch.zeros((1, 3), device=card)
    one = torch.ones(1, dtype=torch.bool, device=card)
    kd, ki = nn_l2.knn_xyz_cuda(q, T(t).to(card), one, torch.ones(nt, dtype=torch.bool,
                                                                    device=card), k)
    assert ki[0, -4:].tolist() == [0, 1, 2, 3]
    assert len(set(kd[0, -4:].tolist())) == 1
    assert sorted(ki[0, :-4].tolist()) == list(range(100, 100 + k - 4))


@pytest.mark.card
def test_card_clusters_far_apart(card):
    """Three tight clusters some 20 m apart, one of them smaller than k:
    most tiles lie beyond a block's k-th distance and are skipped, and the
    small cluster's lists must reach into the others."""
    rng = np.random.default_rng(8)
    centres = np.array([[-12, 0, 0], [12, 3, 1], [0, 14, -1]], np.float32)
    sizes = (3000, 2000, 25)
    p = np.concatenate([c + rng.normal(scale=2.5, size=(m, 3)).astype(np.float32)
                        for c, m in zip(centres, sizes)])
    p = p[rng.permutation(len(p))]
    q = T(p).to(card)
    qv = torch.ones(len(p), dtype=torch.bool, device=card)
    against_plain(q, q, qv, qv, 40, exclude_diag=True)


@pytest.mark.card
def test_card_cube_with_rows_in_the_top_corner_cell(card):
    """A cloud as wide on every axis, its two extreme corners among the
    rows and 48 rows in the top corner cell of the kernel's 32^3 key grid:
    that cell's rows are valid queries and neighbours like any other."""
    rng = np.random.default_rng(9)
    p = rng.uniform(-14, 14, size=(10240, 3)).astype(np.float32)
    p[:48] = rng.uniform(13.2, 14, size=(48, 3))
    p[48], p[49] = (14, 14, 14), (-14, -14, -14)
    p = p[rng.permutation(len(p))]
    q = T(p).to(card)
    qv = torch.ones(len(p), dtype=torch.bool, device=card)
    kd, _ki, _err = against_plain(q, q, qv, qv, 40, exclude_diag=True)
    corner = torch.from_numpy((p >= 13.2).all(1)).to(card)
    assert int(corner.sum()) >= 49 and bool((kd[corner] < BIG).all())
