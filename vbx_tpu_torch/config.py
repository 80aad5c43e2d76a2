"""Typed configuration for the diarization pipeline.

The reference encodes its per-dataset hyperparameters in bash recipes
(reference: AMI_run.sh:45-49, CALLHOME_run.sh:42-47, DIHARD2_run.sh:45-47,
run_example.sh:30-34). Here they are first-class named presets.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VBConfig:
    """VB-HMM hyperparameters (reference: VBx/VBx.py:27-29 defaults and
    VBx/vbhmm.py:154-158 call site)."""

    Fa: float = 0.3
    Fb: float = 17.0
    loop_prob: float = 0.99
    max_iters: int = 40
    epsilon: float = 1e-6
    # dtype for the on-device engine. float32 is the TPU-native choice;
    # float64 is available on CPU for oracle-parity validation.
    dtype: str = "float32"
    # Opt-in f32 plateau stop (engine.vbhmm._plateau_step): freeze a
    # recording whose |Delta-ELBO| stays within plateau_ulps machine
    # quanta of |ELBO| for plateau_iters consecutive iterations. At AMI
    # scale (|ELBO|~1e6) the f32 quantum ~0.1 >> epsilon=1e-6, so a lane
    # can cycle at a few quanta per iteration to max_iters and — under
    # batched convergence freezing — tax the whole padded batch
    # (PARITY.md deviation 3). Measured at AMI scale
    # (BENCHMARKS.md "Plateau-stop A/B"): freezes true quantum-cyclers
    # (e.g. 37 -> 31 iters), never touches genuinely-converging
    # recordings (600+ quanta/iter deltas), device time -12% on the
    # quantizing platform, frame agreement vs the reference rule
    # >= 99.66% per recording. 0.0 = off (reference semantics,
    # VBx/VBx.py:122-125); the corpus presets enable it.
    plateau_ulps: float = 0.0
    plateau_iters: int = 2
    # Forward-backward engine of record for this preset: None = the
    # engine default ('structured' — bit-comparable batched==solo,
    # reference-rule exact; the golden acceptance path). Corpus presets
    # select 'pallas_bf16': measured on the chip at 1.5-3x the structured
    # engine's batched device throughput depending on shape (battery_r4
    # chain_bench 0.98 vs 1.49 ms/iter at B=256/T=1025; ab_s_gt_128 8.9
    # vs 26.6 ms/iter at B=8/T=10k; trace headline 69.6k rec/s) AND the
    # best measured corpus QUALITY under its run-to-max stop policy
    # (>=99.9% per-meeting label agreement vs the frozen reference
    # oracle, corpus DER vs reference 0.021 — the same A/B machinery
    # that justified the plateau stop; scripts/ab_corpus_engine.py).
    # An explicit fb_impl argument (CLI --fb-impl) always wins, and on
    # the CPU backend a pallas selection resolves back to the structured
    # engine (interpret-mode pallas is a debugging path, not a speedup) —
    # see engine.pipeline.resolve_fb_impl.
    fb_impl: str | None = None
    # Stop-rule policy for the bf16-stream engine: its bfloat16 streams
    # put ~sqrt(T)-scale noise on the f32 ELBO, which at corpus scale
    # (T~1e4) fires the delta<epsilon rule AND the plateau stop 3-5x
    # early — measured on the chip: 18 AMI-scale meetings stopped at
    # 5-15 iterations with one meeting at 62% label agreement vs the
    # reference (corpus DER 3.75). The bf16 FIXED POINT is excellent:
    # run to max_iters it measured 99.92% agreement / corpus DER 0.021
    # (better than the f32 engine's adaptive run) in LESS wall time.
    # True (default): whenever the RESOLVED engine is 'pallas_bf16',
    # the pipeline disables both stop rules and runs max_iters flat out
    # (engine.pipeline.effective_vb_stop). The f32/structured engines —
    # including this preset's own CPU fallback — keep the reference
    # epsilon rule and the plateau stop untouched.
    bf16_run_to_max: bool = True


@dataclasses.dataclass(frozen=True)
class AHCConfig:
    """AHC initialization hyperparameters (reference: VBx/vbhmm.py:74-97)."""

    threshold: float = -0.015
    init_smoothing: float = 5.0
    # similarity: 'cosine' (reference default path, vbhmm.py:135) or 'plda'
    # (reference: diarization_lib.kaldi_ivector_plda_scoring_dense)
    similarity: str = "cosine"
    target_energy: float = 1.0
    # 'auto' (default): f64 host similarity + calibration everywhere —
    # the threshold decides the cluster count, and f32 perturbations
    # there measurably shift the VB init (engine.ahc docstring) —
    # EXCEPT long cosine recordings (N >= 16384, the measured
    # device-beats-host crossover) when an accelerator is attached,
    # which stream the O(N^2) calibration
    # sweep through the MXU (threshold agreement ~1e-6, two orders
    # below merge-decision scale; only scalars cross the device
    # boundary). 'host' forces f64 host always; 'device' additionally
    # runs short-recording similarity on the accelerator (serving
    # latency opt-in; labels can differ from 'host' at genuinely tied
    # merges).
    compute_backend: str = "auto"
    # Long-recording AHC fallback (the reference README's own advice for
    # >30-min files, README.md:24): recordings with more than `fallback_n`
    # x-vectors skip AHC and initialize with `random_<fallback_speakers>`
    # instead. 0 disables. Measured crossover (BENCHMARKS.md, 4-core
    # host, round-3 distance-on-demand linkage — O(N·D) memory, no 10 GB
    # condensed buffer): the AHC front half costs ~2 s at N=10k, ~13 s at
    # N=20k, ~103 s / 1.1 GB at N=50k (the N² calibration sweep now
    # dominates) while the random+VB init is O(N); ~50k is where
    # multi-hour files should switch.
    fallback_n: int = 0
    fallback_speakers: int = 16


@dataclasses.dataclass(frozen=True)
class ExtractorConfig:
    """x-vector extraction constants (reference: VBx/predict.py:87-90,145-158,
    VBx/extract.sh:15,32)."""

    feat_dim: int = 64
    embed_dim: int = 256
    seg_len: int = 144
    seg_jump: int = 24
    cmvn_lc: int = 150
    cmvn_rc: int = 149
    min_tail_frames: int = 10
    dither_level: float = 8.0
    dither_seed: int = 3


@dataclasses.dataclass(frozen=True)
class DiarizationConfig:
    """Full pipeline configuration for one dataset."""

    name: str = "example"
    # 'AHC', 'AHC+VB', or 'random_<N>' (reference README.md:24 describes the
    # random_<number> init for long recordings; vbhmm.py:56-59 only ships AHC*)
    init: str = "AHC+VB"
    lda_dim: int = 128
    vb: VBConfig = dataclasses.field(default_factory=VBConfig)
    ahc: AHCConfig = dataclasses.field(default_factory=AHCConfig)
    extractor: ExtractorConfig = dataclasses.field(default_factory=ExtractorConfig)
    output_2nd: bool = False
    sample_rate: int = 16000
    # scoring protocols of record for this dataset (reference: AMI_run.sh:63-65
    # scores forgiving/fair/full; DIHARD2_run.sh:61-62 scores only fair+full)
    protocols: tuple = ("forgiving", "fair", "full")

    def replace(self, **kw) -> "DiarizationConfig":
        return dataclasses.replace(self, **kw)


def _preset(name: str, Fa: float, Fb: float, loopP: float, smoothing: float,
            sample_rate: int,
            protocols: tuple = ("forgiving", "fair", "full"),
            plateau_ulps: float = 0.0,
            fb_impl: str | None = None,
            ) -> DiarizationConfig:
    return DiarizationConfig(
        name=name,
        vb=VBConfig(Fa=Fa, Fb=Fb, loop_prob=loopP,
                    plateau_ulps=plateau_ulps, fb_impl=fb_impl),
        ahc=AHCConfig(threshold=-0.015, init_smoothing=smoothing),
        sample_rate=sample_rate,
        protocols=protocols,
    )


# The config of record (reference recipes; see BASELINE.md table).
# Corpus presets enable the f32 plateau stop (plateau_ulps=4.0): their
# meetings reach |ELBO| scales where the f32 quantum dwarfs epsilon and a
# quantum-cycling recording would otherwise run the whole padded batch to
# max_iters (VBConfig.plateau_ulps). They also select the fused
# pallas_bf16 engine when an accelerator is attached (VBConfig.fb_impl —
# measured bounds and the CPU fallback rule in its docstring). 'example'
# stays reference-exact (golden ES2005a acceptance runs on it).
DATASET_PRESETS = {
    # run_example.sh:30-34 + vbhmm.py:90-97 default smoothing 5.0
    "example": _preset("example", Fa=0.3, Fb=17.0, loopP=0.99, smoothing=5.0,
                       sample_rate=16000),
    # CALLHOME_run.sh:42-47 (8 kHz model)
    "callhome": _preset("callhome", Fa=0.4, Fb=17.0, loopP=0.40, smoothing=7.0,
                        sample_rate=8000, plateau_ulps=4.0,
                        fb_impl="pallas_bf16"),
    # AMI_run.sh:6,45-49 (beamformed: Fb 64)
    "ami_beamformed": _preset("ami_beamformed", Fa=0.4, Fb=64.0, loopP=0.65,
                              smoothing=7.0, sample_rate=16000,
                              plateau_ulps=4.0, fb_impl="pallas_bf16"),
    # AMI_run.sh:6 (Mix-Headset: Fb 68)
    "ami_mixheadset": _preset("ami_mixheadset", Fa=0.4, Fb=68.0, loopP=0.65,
                              smoothing=7.0, sample_rate=16000,
                              plateau_ulps=4.0, fb_impl="pallas_bf16"),
    # DIHARD2_run.sh:42-47; scored fair+full only (DIHARD2_run.sh:61-62)
    "dihard2": _preset("dihard2", Fa=0.2, Fb=6.0, loopP=0.35, smoothing=7.0,
                       sample_rate=16000, protocols=("fair", "full"),
                       plateau_ulps=4.0, fb_impl="pallas_bf16"),
}


def get_preset(name_or_path: str) -> DiarizationConfig:
    """Resolve a dataset config: a named preset, or a path to a YAML/JSON
    file (anything ending .yaml/.yml/.json) holding overrides — the "one
    typed config (dataclass/.yaml) with named dataset presets" the survey
    calls for (SURVEY.md §5 config; the reference's config of record is
    hardcoded bash, AMI_run.sh:45-49 etc.)."""
    if name_or_path.endswith((".yaml", ".yml", ".json")):
        return load_config_file(name_or_path)
    try:
        return DATASET_PRESETS[name_or_path]
    except KeyError:
        raise KeyError(
            f"unknown preset {name_or_path!r}; available: "
            f"{sorted(DATASET_PRESETS)} or a .yaml/.yml/.json config file")


_SUBCONFIGS = {"vb": VBConfig, "ahc": AHCConfig, "extractor": ExtractorConfig}


def config_from_dict(d: dict) -> DiarizationConfig:
    """Typed construction from a plain dict. An optional 'preset' key names
    the base config; every other key overrides a DiarizationConfig field.
    Nested sections ('vb', 'ahc', 'extractor') are partial: unspecified
    fields keep the base's values. Unknown keys raise (typo safety)."""
    d = dict(d)
    preset = d.pop("preset", None)
    base = get_preset(preset) if preset else DiarizationConfig()
    valid = {f.name for f in dataclasses.fields(DiarizationConfig)}
    kw = {}
    for key, val in d.items():
        if key in _SUBCONFIGS:
            if not isinstance(val, dict):
                raise TypeError(f"config section {key!r} must be a mapping, "
                                f"got {type(val).__name__}")
            sub_valid = {f.name for f in dataclasses.fields(_SUBCONFIGS[key])}
            unknown = set(val) - sub_valid
            if unknown:
                raise KeyError(f"unknown {key} config key(s) "
                               f"{sorted(unknown)}; valid: {sorted(sub_valid)}")
            kw[key] = dataclasses.replace(getattr(base, key), **val)
        elif key in valid:
            kw[key] = tuple(val) if key == "protocols" else val
        else:
            raise KeyError(f"unknown config key {key!r}; valid: "
                           f"{sorted(valid)}")
    return base.replace(**kw)


def config_to_dict(cfg: DiarizationConfig) -> dict:
    """Plain-dict form (YAML/JSON-serializable; round-trips through
    config_from_dict)."""
    d = dataclasses.asdict(cfg)
    d["protocols"] = list(d["protocols"])
    return d


def load_config_file(path: str) -> DiarizationConfig:
    """Load a YAML (or JSON — valid YAML) config file. See
    config_from_dict for the schema."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise TypeError(f"config file {path} must hold a mapping at top "
                        f"level, got {type(data).__name__}")
    return config_from_dict(data)
