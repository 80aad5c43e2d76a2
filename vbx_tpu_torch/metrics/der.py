"""Exact event-based diarization scoring (DER + JER).

DER follows NIST md-eval semantics (the engine under dscore/score.py, which
the reference uses for all published numbers — AMI_run.sh:63-65):

- scoring region = UEM (default: [min onset, max offset] over ref+sys turns
  per recording, dscore's gen_uem behavior) minus no-score collars of
  +-`collar` seconds around every *reference* turn boundary,
- with `ignore_overlaps`, regions where >=2 reference speakers are active
  are also excluded (the 'forgiving' protocol),
- one globally optimal one-to-one ref<->sys speaker mapping per recording,
  maximizing jointly-attributed scored time (Hungarian),
- DER = (missed + false-alarm + speaker-confusion time) / scored reference
  speaker time, where overlapping reference speakers each count.

Unlike md-eval/dscore this is computed exactly on the boundary events (no
10 ms frame quantization) in float arithmetic on the host — recordings are
seconds-long lists of intervals, never throughput work.

JER follows dscore's definition (per-reference-speaker Jaccard error against
the optimally mapped system speaker, no collar, mean over ref speakers).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


@dataclasses.dataclass(frozen=True)
class Turn:
    start: float
    end: float
    speaker: str

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class RecordingScore:
    scored_time: float      # total scored reference speaker time
    missed: float
    falarm: float
    confusion: float
    jer: float
    n_ref_speakers: int
    n_sys_speakers: int

    @property
    def error_time(self) -> float:
        return self.missed + self.falarm + self.confusion

    @property
    def der(self) -> float:
        return 100.0 * self.error_time / self.scored_time \
            if self.scored_time > 0 else 0.0


def _subtract_intervals(base: List[Tuple[float, float]],
                        cuts: Sequence[Tuple[float, float]]
                        ) -> List[Tuple[float, float]]:
    """base \\ union(cuts), all as sorted disjoint interval lists."""
    if not cuts:
        return base
    cuts = _merge_intervals(cuts)
    out = []
    for s, e in base:
        cur = s
        for cs, ce in cuts:
            if ce <= cur or cs >= e:
                continue
            if cs > cur:
                out.append((cur, min(cs, e)))
            cur = max(cur, ce)
            if cur >= e:
                break
        if cur < e:
            out.append((cur, e))
    return out


def _merge_intervals(ivs: Iterable[Tuple[float, float]]
                     ) -> List[Tuple[float, float]]:
    ivs = sorted((s, e) for s, e in ivs if e > s)
    out: List[Tuple[float, float]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _clip_turns(turns: Sequence[Turn],
                regions: List[Tuple[float, float]]) -> List[Turn]:
    """Clip turns to the union of the scoring regions.

    Bisect sweep instead of the all-pairs loop: with collars the region
    list has ~2 entries per reference boundary, and turns x regions grows
    to millions of pairs per recording-hour. Regions are merged first —
    the sweep needs them sorted and disjoint, and callers may pass raw
    (possibly overlapping) UEM rows; clipping against the merged union is
    the correct semantics either way (the old all-pairs loop DUPLICATED a
    turn clipped by two overlapping regions)."""
    import bisect

    regions = _merge_intervals(regions)
    starts = [s for s, _ in regions]
    out = []
    for t in turns:
        i = max(bisect.bisect_right(starts, t.start) - 1, 0)
        while i < len(regions):
            s, e = regions[i]
            if s >= t.end:
                break
            cs, ce = max(t.start, s), min(t.end, e)
            if ce > cs:
                out.append(Turn(cs, ce, t.speaker))
            i += 1
    return out


def _snap(t: float, step: float) -> float:
    """Snap a time to the `step` grid, round-half-up (md-eval stores event
    times to hundredths of a second; half-up matches its sprintf-style
    rounding and is robust to 0.249999... float noise)."""
    import math
    return math.floor(t / step + 0.5) * step


def _snap_turns(turns: Sequence[Turn], step: float) -> List[Turn]:
    out = []
    for t in turns:
        s, e = _snap(t.start, step), _snap(t.end, step)
        if e > s:      # a turn shorter than half a frame vanishes
            out.append(Turn(s, e, t.speaker))
    return out


def score_recording(
    ref_turns: Sequence[Turn],
    sys_turns: Sequence[Turn],
    collar: float = 0.0,
    ignore_overlaps: bool = False,
    uem: Optional[Tuple[float, float]] = None,
    rasterize: Optional[float] = None,
) -> RecordingScore:
    """Score one recording. See module docstring for semantics.

    `rasterize`: optional time quantum (seconds; md-eval's storage
    resolution is 0.01). Turn and UEM boundaries are snapped to this grid
    BEFORE scoring — the md-eval-comparable mode: md-eval.pl reads event
    times at 10 ms resolution, so its DER equals exact-event scoring of
    10 ms-snapped inputs. Collar and overlap cuts are then derived from
    the snapped events with exact arithmetic, exactly as md-eval does.
    Divergence from the exact mode is bounded by one quantum of error
    time per boundary event (measured battery: tests/test_metrics.py;
    documented divergences in PARITY.md)."""
    if rasterize:
        ref_turns = _snap_turns(ref_turns, rasterize)
        sys_turns = _snap_turns(sys_turns, rasterize)
        if uem is not None:
            if uem and isinstance(uem[0], (tuple, list)):
                uem = [(_snap(a, rasterize), _snap(b, rasterize))
                       for a, b in uem]
            else:
                uem = (_snap(uem[0], rasterize), _snap(uem[1], rasterize))
    if uem is None:
        all_turns = list(ref_turns) + list(sys_turns)
        if not all_turns:
            return RecordingScore(0.0, 0.0, 0.0, 0.0, 0.0, 0, 0)
        uem = (min(t.start for t in all_turns), max(t.end for t in all_turns))

    # uem: one (onset, offset) pair or a list of them (NIST UEM files can
    # carry several scoring regions per recording, io.uem.read_uem)
    if uem and isinstance(uem[0], (tuple, list)):
        scored = _merge_intervals((float(a), float(b)) for a, b in uem)
    else:
        scored = [(float(uem[0]), float(uem[1]))]
    # dscore trims every turn to the UEM before computing ANY metric, so
    # JER (computed below without collars) must also see only in-UEM time
    ref_turns = _clip_turns(ref_turns, scored)
    sys_turns = _clip_turns(sys_turns, scored)
    # merge STRICTLY-OVERLAPPING same-speaker turns BEFORE deriving collar
    # cuts and overlap regions (dscore/md-eval merge_turns): a same-speaker
    # self-overlap must not count as overlapped speech or double-scored
    # time, but exactly-adjacent same-speaker turns KEEP their boundary —
    # md-eval still places a no-score collar there (see _merge_same_speaker
    # docstring; reproduces the published golden 7.06 exactly)
    ref_turns = _merge_same_speaker(ref_turns)
    sys_turns = _merge_same_speaker(sys_turns)
    # speaker inventories AFTER the UEM trim: a speaker with no in-UEM
    # speech does not exist for scoring (dscore semantics)
    ref_spks = sorted({t.speaker for t in ref_turns})
    sys_spks = sorted({t.speaker for t in sys_turns})
    if collar > 0:
        cuts = []
        for t in ref_turns:
            cuts.append((t.start - collar, t.start + collar))
            cuts.append((t.end - collar, t.end + collar))
        scored = _subtract_intervals(scored, cuts)

    if ignore_overlaps:
        # exclude regions with >= 2 simultaneously active reference speakers
        events = []
        for t in ref_turns:
            events.append((t.start, 1))
            events.append((t.end, -1))
        events.sort()
        depth = 0
        cuts = []
        open_start = None
        for time_, delta in events:
            depth += delta
            if depth >= 2 and open_start is None:
                open_start = time_
            elif depth < 2 and open_start is not None:
                cuts.append((open_start, time_))
                open_start = None
        scored = _subtract_intervals(scored, cuts)

    ref_c = _clip_turns(ref_turns, scored)
    sys_c = _clip_turns(sys_turns, scored)

    # atomic intervals between all boundaries
    bounds = sorted({t.start for t in ref_c} | {t.end for t in ref_c}
                    | {t.start for t in sys_c} | {t.end for t in sys_c})
    nb = len(bounds)
    ridx = {s: i for i, s in enumerate(ref_spks)}
    sidx = {s: i for i, s in enumerate(sys_spks)}
    R, S = len(ref_spks), len(sys_spks)

    # presence masks per atomic interval
    ref_present = np.zeros((nb - 1 if nb else 0, R), dtype=bool)
    sys_present = np.zeros((nb - 1 if nb else 0, S), dtype=bool)
    pos = {b: i for i, b in enumerate(bounds)}
    for t in ref_c:
        i0, i1 = pos[t.start], pos[t.end]
        ref_present[i0:i1, ridx[t.speaker]] = True
    for t in sys_c:
        i0, i1 = pos[t.start], pos[t.end]
        sys_present[i0:i1, sidx[t.speaker]] = True
    durs = np.diff(np.array(bounds)) if nb > 1 else np.zeros(0)

    # optimal mapping on jointly-attributed scored time
    overlap = np.einsum("ir,is,i->rs", ref_present, sys_present, durs) \
        if R and S else np.zeros((R, S))
    mapping = {}
    if R and S:
        rr, ss = linear_sum_assignment(-overlap)
        for r, s in zip(rr, ss):
            if overlap[r, s] > 0:
                mapping[r] = s

    n_ref = ref_present.sum(axis=1)
    n_sys = sys_present.sum(axis=1)
    n_correct = np.zeros(len(durs))
    for r, s in mapping.items():
        n_correct += ref_present[:, r] & sys_present[:, s]

    scored_time = float(np.dot(n_ref, durs))
    missed = float(np.dot(np.maximum(n_ref - n_sys, 0), durs))
    falarm = float(np.dot(np.maximum(n_sys - n_ref, 0), durs))
    confusion = float(np.dot(np.minimum(n_ref, n_sys) - n_correct, durs))

    jer = _jer(ref_turns, sys_turns, ref_spks, sys_spks)
    return RecordingScore(scored_time, missed, falarm, confusion, jer,
                          R, S)


def _merge_same_speaker(turns: Sequence[Turn]) -> List[Turn]:
    """Merge STRICTLY OVERLAPPING same-speaker turns (dscore's merge_turns).

    Exactly-adjacent same-speaker turns stay separate: md-eval still places
    no-score collars at those boundaries, and the published golden score
    (ES2005a forgiving DER 7.06, reference README.md:55) reproduces only
    with that behavior — a full union merge scores 7.05."""
    by: Dict[str, List[Tuple[float, float]]] = {}
    for t in turns:
        by.setdefault(t.speaker, []).append((t.start, t.end))
    out: List[Turn] = []
    for spk, ivs in by.items():
        ivs.sort()
        merged: List[Tuple[float, float]] = []
        for s, e in ivs:
            if merged and s < merged[-1][1]:          # strict overlap only
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        out.extend(Turn(s, e, spk) for s, e in merged)
    out.sort(key=lambda t: (t.start, t.end, t.speaker))
    return out


def _speaker_intervals(turns: Sequence[Turn]) -> Dict[str, List[Tuple[float, float]]]:
    by = {}
    for t in turns:
        by.setdefault(t.speaker, []).append((t.start, t.end))
    return {k: _merge_intervals(v) for k, v in by.items()}


def _total(ivs: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in ivs)


def _intersect_total(a: List[Tuple[float, float]],
                     b: List[Tuple[float, float]]) -> float:
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            tot += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _jer(ref_turns, sys_turns, ref_spks, sys_spks) -> float:
    """dscore JER: optimal mapping on raw (no-collar) overlap; per ref
    speaker jer_i = 1 - |intersection|/|union| with the mapped sys speaker
    (1.0 if unmapped); JER = 100 * mean_i jer_i."""
    if not ref_spks:
        return 0.0
    ref_iv = _speaker_intervals(ref_turns)
    sys_iv = _speaker_intervals(sys_turns)
    R, S = len(ref_spks), len(sys_spks)
    inter = np.zeros((R, S))
    for r, rs in enumerate(ref_spks):
        for s, ss in enumerate(sys_spks):
            inter[r, s] = _intersect_total(ref_iv[rs], sys_iv[ss])
    mapping = {}
    if R and S:
        rr, ss_ = linear_sum_assignment(-inter)
        mapping = {r: s for r, s in zip(rr, ss_)}
    jers = []
    for r, rs in enumerate(ref_spks):
        dur_r = _total(ref_iv[rs])
        if r in mapping:
            s = mapping[r]
            ix = inter[r, s]
            union = dur_r + _total(sys_iv[sys_spks[s]]) - ix
            jers.append(1.0 - ix / union if union > 0 else 0.0)
        else:
            jers.append(1.0)
    return 100.0 * float(np.mean(jers))


def score_corpus(
    ref: Mapping[str, Sequence[Turn]],
    sys: Mapping[str, Sequence[Turn]],
    collar: float = 0.0,
    ignore_overlaps: bool = False,
    uems: Optional[Mapping[str, Tuple[float, float]]] = None,
    rasterize: Optional[float] = None,
) -> Tuple[Dict[str, RecordingScore], RecordingScore]:
    """Score a corpus; returns (per-recording, overall). Overall DER pools
    error/scored time across recordings (md-eval aggregate behavior);
    overall JER averages per-recording JERs weighted by ref speaker count
    (dscore averages over all ref speakers)."""
    per: Dict[str, RecordingScore] = {}
    for rec in sorted(set(ref) | set(sys)):
        per[rec] = score_recording(
            ref.get(rec, ()), sys.get(rec, ()), collar=collar,
            ignore_overlaps=ignore_overlaps,
            uem=None if uems is None else uems.get(rec),
            rasterize=rasterize)
    tot = RecordingScore(
        scored_time=sum(s.scored_time for s in per.values()),
        missed=sum(s.missed for s in per.values()),
        falarm=sum(s.falarm for s in per.values()),
        confusion=sum(s.confusion for s in per.values()),
        # dscore averages over all REFERENCE speakers: a recording with no
        # in-UEM reference speech contributes nothing (weight 0)
        jer=(float(np.average(
            [s.jer for s in per.values()],
            weights=[s.n_ref_speakers for s in per.values()]))
            if any(s.n_ref_speakers for s in per.values()) else 0.0),
        n_ref_speakers=sum(s.n_ref_speakers for s in per.values()),
        n_sys_speakers=sum(s.n_sys_speakers for s in per.values()),
    )
    return per, tot


def _turns_from_rttm(path: str) -> Dict[str, List[Turn]]:
    from vbx_tpu_torch.io.rttm import read_rttm
    out: Dict[str, List[Turn]] = {}
    for seg in read_rttm(path):
        out.setdefault(seg.recording, []).append(
            Turn(seg.start, seg.end, seg.speaker))
    return out


def der_from_rttm_files(ref_rttm: str, sys_rttm: str, collar: float = 0.0,
                        ignore_overlaps: bool = False,
                        rasterize: Optional[float] = None):
    """Score system RTTM against reference RTTM (dscore CLI parity)."""
    return score_corpus(_turns_from_rttm(ref_rttm), _turns_from_rttm(sys_rttm),
                        collar=collar, ignore_overlaps=ignore_overlaps,
                        rasterize=rasterize)
