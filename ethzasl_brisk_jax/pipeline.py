"""Top-level detect+describe facade (the reference's ``BriskFeature``).

``BriskFeature`` = ``ScaleSpaceFeatureDetector<HarrisScoreCalculator>`` +
``BriskDescriptorExtractor`` (``brisk/include/brisk/brisk-feature.h:54-114``).

The jit boundary is per image shape: ``detect_and_compute`` traces once per
(H, W) and is fully batchable with ``jax.vmap`` over a leading frame axis
for the data-parallel frame pipeline.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ethzasl_brisk_jax.core.keypoints import KeyPoints
from ethzasl_brisk_jax.describe.extractor import BriskExtractor
from ethzasl_brisk_jax.detect.scale_space import (
    DetectorConfig,
    detect_keypoints,
)


@dataclasses.dataclass(frozen=True)
class BriskFeature:
    """Composite detector+extractor with reference-equivalent knobs.

    Mirrors BriskFeature(octaves, uniformityRadius, absoluteThreshold,
    maxNumKpt, rotationInvariant, scaleInvariant, version)
    (brisk-feature.h:56-62).
    """

    octaves: int = 0
    uniformity_radius: float = 30.0
    absolute_threshold: float = 0.0
    max_num_kpt: int = 2**31 - 1
    rotation_invariant: bool = True
    scale_invariant: bool = True
    version: str = "v2"
    max_candidates: "int | tuple" = 4096  # scalar or per-layer
    max_keypoints: int = 4096
    refine_dtype: str = "float32"
    topk_impl: str = "sort"   # "block"/"select" = exact alternatives
    topk_block_size: int = 2048
    topk_block_r: int = 256
    # Static per-layer refine-tail budget (None = exact default); see
    # DetectorConfig.refine_capacity.
    refine_capacity: "int | tuple | None" = None
    uniformity_block: int = 256  # greedy-uniformity interaction block
    # Op-by-op detection for golden parity: XLA:CPU's x86 backend
    # FMA-contracts fused mul+add chains (flags and optimization_barrier
    # cannot prevent it — verified in kernel disassembly), which can
    # skew the last ULP of subpixel x/y vs the reference's scalar C++;
    # eager execution rounds each op separately, exactly like the C++.
    eager_exact: bool = False
    # Bit-exact reference angle/theta via host libm atan2f (CPU parity
    # harnesses; see describe.extractor._exact_angle_host).
    angle_exact: bool = False
    # Batched-describe valid-compaction budget PER FRAME (0 = off):
    # the sampler costs per SLOT regardless of validity, so
    # compacting the batch's valid keypoints to a
    # batch*describe_capacity prefix cuts describe roughly by the
    # occupancy factor (extract_descriptors_compact docs; overflow
    # beyond the budget is dropped like any other static cap).
    describe_capacity: int = 0

    def __post_init__(self):
        object.__setattr__(
            self,
            "_config",
            DetectorConfig(
                octaves=self.octaves,
                uniformity_radius=self.uniformity_radius,
                absolute_threshold=self.absolute_threshold,
                max_num_kpt=self.max_num_kpt,
                max_candidates=self.max_candidates,
                max_keypoints=self.max_keypoints,
                refine_dtype=self.refine_dtype,
                topk_impl=self.topk_impl,
                topk_block_size=self.topk_block_size,
                topk_block_r=self.topk_block_r,
                refine_capacity=self.refine_capacity,
                uniformity_block=self.uniformity_block,
            ),
        )
        object.__setattr__(
            self,
            "_extractor",
            BriskExtractor(
                rotation_invariant=self.rotation_invariant,
                scale_invariant=self.scale_invariant,
                version=self.version,
                angle_exact=self.angle_exact,
            ),
        )

    @property
    def extractor(self) -> BriskExtractor:
        return self._extractor

    @property
    def config(self) -> DetectorConfig:
        return self._config

    @property
    def descriptor_bytes(self) -> int:
        return self._extractor.descriptor_bytes

    def detect(self, img: jnp.ndarray) -> KeyPoints:
        kps = detect_keypoints(img, self._config)
        if kps.capacity > self.max_keypoints:
            kps = kps.top_k(self.max_keypoints)
        return kps

    def detect_with_diagnostics(self, img: jnp.ndarray):
        """detect() + a DetectDiagnostics certifying that no capacity
        knob (per-layer candidate caps, block top-k, refine caps)
        truncated on THIS image — ~zero extra cost (the counts are sums
        of masks the pass already computes). Assert ``diag.ok`` when
        running the perf backends on new data (bench.py does, on its
        frames, before every timed run)."""
        kps, diag = detect_keypoints(
            img, self._config, with_diagnostics=True
        )
        if kps.capacity > self.max_keypoints:
            kps = kps.top_k(self.max_keypoints)
        return kps, diag

    def compute(
        self, img: jnp.ndarray, keypoints: KeyPoints
    ) -> tuple[KeyPoints, jnp.ndarray]:
        return self._extractor(img, keypoints)

    @partial(jax.jit, static_argnames=("self",))
    def _detect_jit(self, img: jnp.ndarray) -> KeyPoints:
        return self.detect(img)

    def detect_and_compute(
        self, img: jnp.ndarray
    ) -> tuple[KeyPoints, jnp.ndarray]:
        """Detect keypoints and compute descriptors on one uint8 image.

        Two jit stages: detection (config static, no large constants) and
        description (pattern tables threaded as runtime arguments, not
        baked in as jit closure constants — see DevicePattern).
        """
        kps = self.detect(img) if self.eager_exact else self._detect_jit(img)
        return self._extractor(img, kps)


@dataclasses.dataclass(frozen=True)
class BriskFeatureDetector:
    """Classic AGAST/OAST detection facade + BRISK description.

    Mirrors ``brisk::BriskFeatureDetector(thresh, octaves,
    suppressScaleNonmaxima)`` (``brisk-feature-detector.h:56-57``) paired
    with ``BriskDescriptorExtractor`` as in the reference's AST golden run
    (``test-binary-equal.cc:322-331``) and match test (``test-match.cc``).
    """

    threshold: int = 70
    octaves: int = 3
    suppress_scale_nonmaxima: bool = True
    rotation_invariant: bool = True
    scale_invariant: bool = True
    version: str = "v2"
    # int, or a per-layer tuple (detect cost scales with the
    # slot total; see detect_ast_keypoints docs).
    max_candidates_per_layer: "int | tuple" = 2048
    # Lazy-score-cache model for the IsMax2D tie path
    # (brisk-scale-space.cc:482-530): "emulated" (vectorized two-pass
    # approximation), "exact" (sequential fori_loop emulation,
    # bit-exact), or "fresh" (no history).
    raw_cache_model: str = "emulated"
    # Run detection eagerly (op-by-op) instead of under one jit.  The
    # x86 backend of XLA:CPU contracts mul+add chains into FMA inside
    # fusions regardless of flags or HLO optimization_barrier (verified
    # in disassembly), which skews ~1/3 of refined responses/sizes by
    # 1-2 ULP vs the compiled reference; op-by-op execution rounds every
    # op separately, exactly like the reference's scalar C++.  Used by
    # the golden-parity harness; ~same speed on CPU once op caches warm.
    eager_exact: bool = False
    # Bit-exact reference angle/theta via host libm atan2f (CPU parity
    # harnesses; see describe.extractor._exact_angle_host).
    angle_exact: bool = False
    # Detection backend: "candidates" = the per-candidate gather path
    # (ast_scale_space.py; supports every raw_cache_model and the
    # passed-keypoints / non-suppressed modes); "dense" = whole-map
    # decisions with one final gather (ast_dense.py; emulated model,
    # suppressed mode only — bitwise-equal outputs).
    detect_impl: str = "candidates"

    def __post_init__(self):
        object.__setattr__(
            self,
            "_extractor",
            BriskExtractor(
                rotation_invariant=self.rotation_invariant,
                scale_invariant=self.scale_invariant,
                version=self.version,
                angle_exact=self.angle_exact,
            ),
        )
        if self.detect_impl == "dense":
            assert self.raw_cache_model == "emulated", (
                "dense detect implements the emulated cache model only"
            )
            assert self.suppress_scale_nonmaxima, (
                "dense detect implements the suppressed mode only"
            )

    @property
    def extractor(self) -> BriskExtractor:
        return self._extractor

    def detect_with_diagnostics(self, img: jnp.ndarray):
        """detect() + an AstDiagnostics certifying the per-layer
        candidate capacities did not truncate on THIS image (overflow
        silently drops corners; bench.py asserts this on its frames
        before timing)."""
        from ethzasl_brisk_jax.detect.ast_scale_space import (
            detect_ast_keypoints,
        )

        return detect_ast_keypoints(
            img,
            threshold=self.threshold,
            octaves=self.octaves,
            max_candidates_per_layer=self.max_candidates_per_layer,
            suppress_scale_nonmaxima=self.suppress_scale_nonmaxima,
            raw_cache_model=self.raw_cache_model,
            v1=(self.version == "v1"),
            with_diagnostics=True,
        )

    def detect(self, img: jnp.ndarray) -> KeyPoints:
        if self.detect_impl == "dense":
            from ethzasl_brisk_jax.detect.ast_dense import (
                detect_ast_keypoints_dense,
            )

            return detect_ast_keypoints_dense(
                img,
                threshold=self.threshold,
                octaves=self.octaves,
                max_candidates_per_layer=self.max_candidates_per_layer,
                v1=(self.version == "v1"),
            )
        from ethzasl_brisk_jax.detect.ast_scale_space import (
            detect_ast_keypoints,
        )

        return detect_ast_keypoints(
            img,
            threshold=self.threshold,
            octaves=self.octaves,
            max_candidates_per_layer=self.max_candidates_per_layer,
            suppress_scale_nonmaxima=self.suppress_scale_nonmaxima,
            raw_cache_model=self.raw_cache_model,
            # version="v1" selects the legacy engine end to end: plain
            # OAST detection without the adaptive threshold map, no
            # scale-axis weak/edge gates, drop threshold = center
            # (brisk-v1.cc:595-1110), plus the v1 ring pattern in the
            # extractor.
            v1=(self.version == "v1"),
        )

    @partial(jax.jit, static_argnames=("self",))
    def _detect_jit(self, img: jnp.ndarray) -> KeyPoints:
        return self.detect(img)

    def detect_and_compute(
        self, img: jnp.ndarray
    ) -> tuple[KeyPoints, jnp.ndarray]:
        kps = self.detect(img) if self.eager_exact else self._detect_jit(img)
        return self._extractor(img, kps)


@dataclasses.dataclass(frozen=True)
class HarrisFeatureDetector:
    """Standalone single-scale Harris detector.

    Mirrors ``brisk::HarrisFeatureDetector(threshold, radius, maxKpts)``
    (``brisk/include/brisk/harris-feature-detector.h:54-80``): dense Harris
    scores, 2-D non-max suppression and radial-LUT uniformity enforcement —
    realized as the octaves=0 configuration of the generic dense scale-space
    pipeline (same kernels, same greedy-uniformity semantics).
    """

    threshold: float = 0.0
    uniformity_radius: float = 30.0
    max_num_kpt: int = 2**31 - 1
    max_candidates: int = 4096

    def __post_init__(self):
        object.__setattr__(
            self,
            "_feature",
            BriskFeature(
                octaves=0,
                uniformity_radius=self.uniformity_radius,
                absolute_threshold=self.threshold,
                max_num_kpt=self.max_num_kpt,
                max_candidates=self.max_candidates,
                max_keypoints=self.max_candidates,
            ),
        )

    def detect(self, img: jnp.ndarray) -> KeyPoints:
        return self._feature._detect_jit(img)


def compute_scale(
    detector: BriskFeatureDetector, img: jnp.ndarray, keypoints: KeyPoints
) -> KeyPoints:
    """Re-detect provided keypoints through the AST scale space.

    Exact ``BriskFeatureDetector::ComputeScale``
    (brisk-feature-detector.cc:87-92): GetKeypoints in usePassedKeypoints
    mode (brisk-scale-space.cc:103-124) with overwrite_lower_thres=0 —
    every keypoint is mapped into every layer, the 2-D maximum check is
    skipped, and the normal subpixel/3-D refinement machinery emits the
    refined keypoints (one output slot per (keypoint, layer); a keypoint
    surviving several layers appears once per layer, like the reference's
    vector output).
    """
    from ethzasl_brisk_jax.detect.ast_scale_space import (
        detect_ast_keypoints,
    )

    return detect_ast_keypoints(
        img,
        threshold=detector.threshold,
        octaves=detector.octaves,
        suppress_scale_nonmaxima=detector.suppress_scale_nonmaxima,
        passed_keypoints=keypoints,
        lower_threshold=0,
    )
