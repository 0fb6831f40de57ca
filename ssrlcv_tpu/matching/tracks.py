"""N-view exhaustive matching and track building.

Pairwise matching runs on device (the integer-matmul matcher); the transitive-chain
track assembly is a faithful transliteration of the reference's host
algorithm (generateMatchesExhaustive, MatchFactory.cu:907-1028), including
its quirks:

  * adjacency entries sorted lexicographically by (image, feature) — the
    pair loop emits them in target-image order so they arrive sorted;
  * a chain is accepted only if each next hop's adjacency set is a subset of
    the previous one (full set_intersection check), rejected otherwise;
  * tracks are only rooted at query images 0..n-3 (the reference's inner
    loop guard ``i < images.size() - 2`` skips the last pair);
  * consumed adjacency lists are cleared so no keypoint appears in two
    tracks.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ssrlcv_tpu.config import MatchParams
from ssrlcv_tpu.core.types import Cameras, FeatureSet, MatchSet

# max match programs in flight before the oldest result is fetched: deep
# enough to hide the fetch latency behind queued device work,
# shallow enough to cap live DMatch HBM buffers at large pair counts
DISPATCH_WINDOW = 16


def overlap_pairs(n: int, ordered: bool, estimated_overlap: float) -> list[tuple[int, int]]:
    """The (i < j) pair list with the reference's linear-sequence pair skip
    (generateMatchesExhaustive, MatchFactory.cu:908-936) — for ordered
    captures only pairs close enough in the sequence to overlap are matched:
    pair (i, j) is kept while (j - i) * (1 - overlap) <= 1.  (The
    reference's counter `++i*(1-estimatedOverlap) > 1.0f` expresses the same
    intent through a loop-local counter; the semantic form is used here.)"""
    return [
        (i, j)
        for i in range(n - 1)
        for j in range(i + 1, n)
        if not (ordered and estimated_overlap > 0.0
                and (j - i) * (1.0 - estimated_overlap) > 1.0)
    ]


def pairwise_index_matches(
    features: list[FeatureSet],
    cameras: Cameras,
    params: MatchParams,
    seed_features: Optional[FeatureSet] = None,
    ordered: bool = False,
    estimated_overlap: float = 0.0,
    mesh=None,
) -> dict[tuple[int, int], np.ndarray]:
    """Best-match index pairs for every surviving (i < j) image pair
    (generateMatchesDoubleConstrainedIndexOnly per pair).
    Returns {(i, j): (n, 2) array of (query_feature, target_feature)}.

    ``mesh``: optional jax Mesh — the pair sweep is then dealt round-robin
    over the mesh devices (parallel.sharded.sharded_pairwise_index_matches)
    with identical per-pair results.
    """
    from ssrlcv_tpu.matching import match as M

    n = len(features)
    pairs = overlap_pairs(n, ordered, estimated_overlap)
    if mesh is not None:
        from ssrlcv_tpu.parallel.sharded import sharded_pairwise_index_matches

        return sharded_pairwise_index_matches(
            mesh, features, cameras, params, seed_features, pairs=pairs)

    state = {"sd": None, "sd_img": -1}

    def dispatch(k, ij):
        i, j = ij
        if seed_features is not None and state["sd_img"] != i:
            state["sd"] = M.seed_distances(features[i], seed_features)
            state["sd_img"] = i
        # index_only=True: the reference's exhaustive pairing goes through
        # the IndexOnly kernel family whose relative-seed threshold is
        # UNSQUARED (MatchFactory.cu:2907 vs the DMatch kernels' :2278)
        if params.mode == "double":
            return M.match_double_constrained(
                features[i], features[j], cameras, i, j, params,
                seed_dist=state["sd"], index_only=True,
            )
        return M.match_brute_force(
            features[i], features[j], params, seed_dist=state["sd"],
            index_only=True)

    return windowed_pair_sweep(pairs, dispatch, DISPATCH_WINDOW)


def windowed_pair_sweep(pairs, dispatch, window: int):
    """Dispatch pairs ahead of the fetches (async) with a BOUNDED window —
    the device works through the queue while the host pulls earlier results,
    but at most ``window`` pairs' DMatch buffers are live on device at once
    (unbounded dispatch held every pair's output simultaneously: multi-GB
    HBM pressure at large N — ADVICE r4).  Shared by the serial sweep and
    parallel.sharded's multi-device sweep so the fetch epilogue cannot
    drift between them.

    ``dispatch(k, pair)`` -> DMatches; returns {pair: (n, 2) int64 of
    (query_feature, target_feature)}."""
    dms = {}
    out = {}

    def fetch(key):
        dm = dms.pop(key)
        valid = np.asarray(dm.valid)
        qf = np.nonzero(valid)[0]
        tf = np.asarray(dm.target_idx)[qf]
        out[key] = np.stack([qf, tf], axis=1).astype(np.int64)

    for k, ij in enumerate(pairs):
        dms[ij] = dispatch(k, ij)
        if k >= window:
            fetch(pairs[k - window])
    for key in list(dms.keys()):
        fetch(key)
    return out


def build_tracks(
    pair_matches: dict[tuple[int, int], np.ndarray],
    num_images: int,
    feature_counts: list[int],
) -> list[list[tuple[int, int]]]:
    """Adjacency-chain track assembly (MatchFactory.cu:946-1010).
    Returns a list of tracks, each a list of (image, feature) pairs.

    Host-side but engineered for scale: hops are packed into single ints
    (code = image * stride + feature) so the chain subset checks are set ops
    on ints instead of tuple hashing, and match arrays are converted with
    ``tolist()`` once instead of per-element numpy-scalar unboxing.  10
    images x 30k features builds in ~1 s (tests/test_matching.py benchmark).
    """
    stride = max(feature_counts) + 1 if feature_counts else 1
    last = num_images - 1
    adjacency: list[dict[int, list[int]]] = [{} for _ in range(num_images - 1)]
    for (i, j), pairs in sorted(pair_matches.items()):
        jbase = j * stride
        adj_i = adjacency[i]
        for qf, tf in pairs.tolist():
            code = jbase + tf
            lst = adj_i.get(qf)
            if lst is None:
                adj_i[qf] = [code]
            else:
                lst.append(code)
    # entries are appended in increasing j per construction -> sorted

    tracks: list[list[tuple[int, int]]] = []
    # reference guard: ``i < images.size() - 2`` — tracks are never rooted
    # at the second-to-last image
    for i in range(num_images - 2):
        adj_i = adjacency[i]
        for f in sorted(adj_i.keys()):
            adj = adj_i[f]
            if not adj:
                continue
            bad = False
            prev_adj = adj
            prev_set = None
            while True:
                jx, jy = divmod(prev_adj[0], stride)
                if jx == last:
                    break
                next_adj = adjacency[jx].get(jy)
                if not next_adj:
                    break
                # full-intersection chain check: every next-hop entry must
                # already be in the previous adjacency (set_intersection
                # semantics; entries are unique per construction)
                if prev_set is None:
                    prev_set = set(prev_adj)
                if not prev_set.issuperset(next_adj):
                    bad = True
                    break
                elif len(next_adj) == 1:
                    break
                else:
                    prev_adj = next_adj
                    prev_set = set(next_adj)
            if bad:
                adj_i[f] = []
            else:
                track = [(i, f)] + [divmod(c, stride) for c in adj]
                tracks.append(track)
                # clear consumed adjacency (all but the last hop)
                for c in adj[:-1]:
                    mx, my = divmod(c, stride)
                    if mx == last:
                        break
                    adjacency[mx][my] = []
    return tracks


def generate_matches_exhaustive(
    features: list[FeatureSet],
    cameras: Cameras,
    params: MatchParams,
    seed_features: Optional[FeatureSet] = None,
    ordered: bool = False,
    estimated_overlap: float = 0.0,
    mesh=None,
) -> MatchSet:
    """Full N-view matching -> padded MatchSet (generateMatchesExhaustive,
    MatchFactory.cu:908-1028; the overlap pair skip is honoured for
    ordered linear captures).  ``mesh``: distribute the pair sweep over the
    mesh devices."""
    pair_matches = pairwise_index_matches(
        features, cameras, params, seed_features,
        ordered=ordered, estimated_overlap=estimated_overlap, mesh=mesh,
    )
    counts = [f.capacity for f in features]
    tracks = build_tracks(pair_matches, len(features), counts)

    locs = [np.asarray(f.loc) for f in features]
    t = len(tracks)
    v = max((len(tr) for tr in tracks), default=2)
    cap = max(((t + 127) // 128) * 128, 128)
    kp_loc = np.zeros((cap, v, 2), np.float32)
    kp_par = np.full((cap, v), -1, np.int32)
    nviews = np.zeros(cap, np.int32)
    mask = np.zeros(cap, bool)
    for k, tr in enumerate(tracks):
        for s, (img, feat) in enumerate(tr):
            kp_loc[k, s] = locs[img][feat]
            kp_par[k, s] = img
        nviews[k] = len(tr)
        mask[k] = True
    return MatchSet(
        kp_loc=jnp.asarray(kp_loc),
        kp_parent=jnp.asarray(kp_par),
        num_views=jnp.asarray(nviews),
        mask=jnp.asarray(mask),
    )
