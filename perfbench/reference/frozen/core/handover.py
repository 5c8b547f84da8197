# Frozen copy of src/repro_torch/core/handover.py at commit ed1d7aa (unchanged but
# for this header): the NumPy control plane that the benchmark's
# reference replays to work out the dataset, partition, pools, plans and
# batches again, independently of the program under test.
"""Intra-layer data/model handover at the space layer (Section III-C).

Implements the seamless-handover schedule of eqs. (8)-(12): the current
satellite trains on D_S until its coverage window over the target region
ends; if unfinished it transmits the model + the dataset to the next
incoming satellite over the ISL (handover delay eq. 7), which resumes.
"""
from __future__ import annotations

import dataclasses
from typing import List

from . import latency as lat
from .network import SAGIN


@dataclasses.dataclass
class HandoverLeg:
    sat_index: int
    start_time: float            # when this satellite starts processing
    handover_delay: float        # ISL delay paid to *reach* this satellite
    samples_processed: float
    end_time: float              # when it stops (done or coverage end)


@dataclasses.dataclass
class SpaceSchedule:
    legs: List[HandoverLeg]
    total_latency: float
    completed: bool

    @property
    def n_handovers(self) -> int:
        return max(0, len(self.legs) - 1)


def space_schedule(n_samples: float, sagin: SAGIN) -> SpaceSchedule:
    """Compute the space-layer schedule for processing ``n_samples``.

    Faithful to eqs. (8)-(12): satellite i becomes active at
    T_{i-1} + tau^hand_{i-1,i}; it can process (f_i/m_i) * available_time
    samples before its own coverage end T_i. Returns the full schedule and
    tau_S^{(r)} (eq. 10).
    """
    legs: List[HandoverLeg] = []
    if n_samples <= 0:
        return SpaceSchedule(legs=[], total_latency=0.0, completed=True)

    remaining = float(n_samples)
    t = 0.0  # current wall-clock within the round
    for i, sat in enumerate(sagin.satellites):
        hand = 0.0
        if i > 0:
            # handover pays for the model + the *entire remaining* dataset
            # (the paper hands over D_S^{(r+1)}; eq. 7 uses |D_S^{(r+1)}|,
            # we use the unprocessed remainder which is what must move).
            hand = lat.handover_delay(sagin.model_bits, sagin.q_bits,
                                      remaining, sagin.z_isl)
            t = t + hand
        start = t
        finish_time = lat.comp_time(sat.m, remaining, sat.f)
        if start + finish_time <= sat.coverage_end:
            legs.append(HandoverLeg(sat.index, start, hand, remaining,
                                    start + finish_time))
            return SpaceSchedule(legs=legs, total_latency=start + finish_time,
                                 completed=True)
        # partial processing until coverage end
        avail = max(0.0, sat.coverage_end - start)
        done = (sat.f / sat.m) * avail
        done = min(done, remaining)
        legs.append(HandoverLeg(sat.index, start, hand, done,
                                sat.coverage_end))
        remaining -= done
        t = sat.coverage_end
    # Ran out of known incoming satellites: extrapolate with the last
    # satellite's parameters (an unbounded-coverage virtual satellite), so
    # the optimizer always sees a finite, monotone latency.
    last = sagin.satellites[-1]
    hand = lat.handover_delay(sagin.model_bits, sagin.q_bits, remaining,
                              sagin.z_isl)
    t += hand
    finish = lat.comp_time(last.m, remaining, last.f)
    legs.append(HandoverLeg(-1, t, hand, remaining, t + finish))
    return SpaceSchedule(legs=legs, total_latency=t + finish, completed=True)


def _schedule_from(t0: float, n_samples: float, satellites,
                   sagin: SAGIN) -> SpaceSchedule:
    """Schedule ``n_samples`` over ``satellites`` starting at wall time
    ``t0``, paying a leading ISL handover into the first satellite —
    the eq. (8)-(12) walk of :func:`space_schedule` re-rooted mid-round
    (used by unplanned-handover recovery).  Falls back to the virtual
    unbounded-coverage satellite when the chain runs dry, exactly as
    the planner does.
    """
    legs: List[HandoverLeg] = []
    remaining = float(n_samples)
    t = t0
    sats = list(satellites) if satellites else [sagin.satellites[-1]]
    for i, sat in enumerate(sats):
        hand = lat.handover_delay(sagin.model_bits, sagin.q_bits,
                                  remaining, sagin.z_isl)
        t = t + hand
        start = t
        finish_time = lat.comp_time(sat.m, remaining, sat.f)
        if start + finish_time <= sat.coverage_end or i == len(sats) - 1:
            # last known satellite extrapolates unbounded (virtual
            # successor), keeping recovery latency finite and monotone
            legs.append(HandoverLeg(sat.index, start, hand, remaining,
                                    start + finish_time))
            return SpaceSchedule(legs=legs,
                                 total_latency=start + finish_time,
                                 completed=True)
        avail = max(0.0, sat.coverage_end - start)
        done = min((sat.f / sat.m) * avail, remaining)
        legs.append(HandoverLeg(sat.index, start, hand, done,
                                sat.coverage_end))
        remaining -= done
        t = sat.coverage_end
    return SpaceSchedule(legs=legs, total_latency=t, completed=True)


def replan_after_loss(schedule: SpaceSchedule, loss_time: float,
                      sagin: SAGIN):
    """Recover from the serving satellite dying mid-coverage.

    The planned ``schedule`` assumed its legs run to completion; at wall
    time ``loss_time`` (within the round) the active satellite is lost
    without warning.  Recovery truncates the active leg at the loss
    instant, pays an UNPLANNED handover — model + the *unprocessed*
    remainder — to the successor satellite over the ISL (eq. 7), and
    resumes the eq. (8)-(12) walk there.

    Returns ``(recovered, restart_latency)``: the recovered
    :class:`SpaceSchedule` (original legs up to the loss + the re-planned
    tail) and the latency of the naive alternative — restarting the
    whole space computation from scratch on the successor (re-sending
    the model + the FULL dataset and reprocessing everything) — the
    baseline the recovered path must beat
    (gated in ``benchmarks/resilience.py``).
    """
    if not schedule.legs:
        return schedule, schedule.total_latency
    total = sum(leg.samples_processed for leg in schedule.legs)
    loss_time = min(max(0.0, loss_time), schedule.total_latency)
    if loss_time >= schedule.total_latency:
        return schedule, schedule.total_latency  # already finished
    # active leg: the one whose [start, end) window holds the loss
    j = len(schedule.legs) - 1
    for i, leg in enumerate(schedule.legs):
        if loss_time < leg.end_time:
            j = i
            break
    active = schedule.legs[j]
    kept = list(schedule.legs[:j])
    window = max(active.end_time - active.start_time, 0.0)
    frac = ((loss_time - active.start_time) / window) if window > 0 else 0.0
    frac = min(max(frac, 0.0), 1.0)
    partial = frac * active.samples_processed
    if partial > 0:
        kept.append(HandoverLeg(active.sat_index, active.start_time,
                                active.handover_delay, partial, loss_time))
    done_before = sum(leg.samples_processed for leg in kept)
    remaining = max(0.0, total - done_before)
    successors = sagin.satellites[j + 1:]
    tail = _schedule_from(loss_time, remaining, successors, sagin)
    recovered = SpaceSchedule(legs=kept + tail.legs,
                              total_latency=tail.total_latency,
                              completed=True)
    restart = _schedule_from(loss_time, total, successors,
                             sagin).total_latency
    return recovered, restart


def space_latency(n_samples: float, sagin: SAGIN) -> float:
    """tau_S^{(r)} (eq. 10) as a scalar."""
    return space_schedule(n_samples, sagin).total_latency
