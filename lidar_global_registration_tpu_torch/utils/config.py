"""YAML config + Cartesian parameter expansion
(lidar_global_registration_tpu/utils/config.py, copied: pure host code).

Reference: include/config.h (YamlConfig with typed get / getVector where a
scalar is promoted to a 1-vector so every option is sweepable) and
getParametersFromConfig (src/common.cpp:210-415) which expands the product
of all list-valued options into a list of AlignmentParameters, deriving
distance_thr = 4 * max(density) and iss_radius = 2 * density when unset.
"""
from __future__ import annotations

import itertools
from typing import Any, Optional

from lidar_global_registration_tpu_torch.types import (
    ALIGNMENT_RANSAC,
    AlignmentParameters,
    FEATURE_NR_POINTS,
    FEATURES_REESTIMATE_FRAMES,
    FEATURES_SCALE_FACTOR,
    KEYPOINT_ISS,
    DESCRIPTOR_SHOT,
    DEFAULT_LRF,
    MATCHING_CLUSTER,
    MATCHING_CLUSTER_K,
    METRIC_SCORE_MSE,
    METRIC_UNIFORMITY,
    METRIC_WEIGHT_CONSTANT,
    NORMAL_NR_POINTS,
    ALIGNMENT_EDGE_THR,
    ALIGNMENT_CONFIDENCE,
    ALIGNMENT_USE_BFMATCHER,
    ALIGNMENT_RANDOMNESS,
    ALIGNMENT_N_SAMPLES,
    ALIGNMENT_BLOCK_SIZE,
)


class Config:
    """Thin typed wrapper over a YAML mapping (config.h:6-69)."""

    def __init__(self, node: Optional[dict] = None):
        self.node = node or {}

    @classmethod
    def load(cls, path: str) -> "Config":
        import yaml  # only a config read from a file needs PyYAML

        with open(path) as f:
            return cls(yaml.safe_load(f))

    def get(self, key: str, default: Any = None) -> Any:
        v = self.node.get(key)
        return default if v is None else v

    def set(self, key: str, value: Any) -> None:
        self.node[key] = value

    def get_vector(self, key: str, default: Any = None):
        """Scalar -> 1-vector promotion; None default -> None (optional)."""
        if key not in self.node or self.node[key] is None:
            return None if default is None else [default]
        v = self.node[key]
        if isinstance(v, list):
            return v
        return [v]

    def tests(self):
        """The `tests:` multi-test list (main.cpp:384-407): each entry is a
        one-key mapping {test|compare|keypoint|measure: {...}}."""
        t = self.node.get("tests")
        if not t:
            return None
        out = []
        for entry in t:
            (test_type, node), = entry.items()
            out.append((test_type, Config(node)))
        return out


def expand_parameters(
    config: Config,
    density_src: float,
    density_tgt: float,
    normals_available: bool,
    vp_src=None,
    vp_tgt=None,
) -> list[AlignmentParameters]:
    """Cartesian sweep over all list-valued options (common.cpp:210-415)."""
    base = AlignmentParameters(
        edge_thr_coef=float(config.get("edge_thr", ALIGNMENT_EDGE_THR)),
        max_iterations=int(config.get("iteration", 2**31 - 1)),
        confidence=float(config.get("confidence", ALIGNMENT_CONFIDENCE)),
        use_bfmatcher=bool(config.get("bf", ALIGNMENT_USE_BFMATCHER)),
        randomness=int(config.get("randomness", ALIGNMENT_RANDOMNESS)),
        n_samples=int(config.get("n_samples", ALIGNMENT_N_SAMPLES)),
        save_features=bool(config.get("save_features", False)),
        bf_block_size=int(config.get("block_size", ALIGNMENT_BLOCK_SIZE)),
        normals_available=normals_available,
        vp_src=vp_src,
        vp_tgt=vp_tgt,
    )
    # extras of the staged path (not in the reference schema; optional)
    if config.get("hypothesis_batch") is not None:
        base = base.replace(hypothesis_batch=int(config.get("hypothesis_batch")))
    if config.get("bf16_matching") is not None:
        base = base.replace(bf16_matching=bool(config.get("bf16_matching")))

    sweeps: list[tuple[str, list]] = []

    def add(key, yaml_key, values, transform=lambda x: x):
        sweeps.append((key, [transform(v) for v in values]))

    add("alignment_id", "alignment", config.get_vector("alignment", ALIGNMENT_RANSAC), str)
    add("keypoint_id", "keypoint", config.get_vector("keypoint", KEYPOINT_ISS), str)

    dthr = config.get_vector("distance_thr")
    if dthr is not None:
        add("distance_thr", "distance_thr", dthr, float)
    else:
        auto_thr = 4.0 * max(density_src, density_tgt)
        base = base.replace(distance_thr=auto_thr)

    fr = config.get_vector("feature_radius", 0.0)
    add("feature_radius", "feature_radius", fr, lambda v: None if float(v) <= 0 else float(v))
    add("feature_nr_points", "feature_nr", config.get_vector("feature_nr", FEATURE_NR_POINTS), int)
    add("normal_nr_points", "normal_nr", config.get_vector("normal_nr", NORMAL_NR_POINTS), int)
    add(
        "reestimate_frames",
        "reestimate",
        config.get_vector("reestimate", FEATURES_REESTIMATE_FRAMES),
        bool,
    )

    iss = config.get_vector("iss_radius")
    if iss is not None:
        sweeps.append(("__iss__", [float(v) for v in iss]))
    else:
        base = base.replace(
            iss_radius_src=2.0 * density_src, iss_radius_tgt=2.0 * density_tgt
        )

    add("descriptor_id", "descriptor", config.get_vector("descriptor", DESCRIPTOR_SHOT), str)
    add("lrf_id", "lrf", config.get_vector("lrf", DEFAULT_LRF), str)
    add("metric_id", "metric", config.get_vector("metric", METRIC_UNIFORMITY), str)
    add("matching_id", "matching", config.get_vector("matching", MATCHING_CLUSTER), str)
    add("weight_id", "weight", config.get_vector("weight", METRIC_WEIGHT_CONSTANT), str)
    add("score_id", "score", config.get_vector("score", METRIC_SCORE_MSE), str)
    add("scale_factor", "scale", config.get_vector("scale", FEATURES_SCALE_FACTOR), float)
    add("cluster_k", "cluster_k", config.get_vector("cluster_k", MATCHING_CLUSTER_K), int)

    out = []
    keys = [k for k, _ in sweeps]
    for combo in itertools.product(*[v for _, v in sweeps]):
        kw = {}
        for k, v in zip(keys, combo):
            if k == "__iss__":
                kw["iss_radius_src"] = v
                kw["iss_radius_tgt"] = v
            else:
                kw[k] = v
        out.append(base.replace(**kw))
    return out
