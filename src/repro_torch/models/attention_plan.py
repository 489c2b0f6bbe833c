"""Tensor-parallel attention head planning.

The production mesh fixes TP=16, but several assigned architectures have
query/KV head counts that 16 does not divide (qwen2-7b: 28q/4kv,
smollm: 15q/5kv, ...).  We solve this with a *q-head permutation + padding +
KV slot replication* plan:

* pad ``n_q`` to a multiple of TP (zero-initialized q columns; their output
  rows in W_o are zero, so they contribute nothing),
* lay the padded q heads out so that the ``h = n_q_pad/TP`` heads on each
  device all share one original KV head (group-by-group allocation, padding
  each KV group's head list to a multiple of ``h``),
* materialize exactly ``TP`` physical KV slots (one per device), slot ``d``
  holding a copy of the KV head its q heads need.

Compute-wise the result is plain GQA with uniform group size ``h``.  The KV
cache is replicated ``TP/n_kv``-fold — far cheaper than full MHA expansion
(e.g. qwen2-7b: 16 physical KV slots instead of 32).  When ``n_kv`` is
already a multiple of TP the plan is the identity.
"""
from __future__ import annotations

import dataclasses



@dataclasses.dataclass(frozen=True)
class HeadPlan:
    n_q: int
    n_kv: int
    tp: int
    n_q_pad: int
    n_kv_phys: int
    h_per_slot: int                  # q heads per physical kv slot
    q_slot_to_orig: tuple[int, ...]  # padded q position -> original q head (-1 = pad)
    kv_slot_to_orig: tuple[int, ...] # physical kv slot -> original kv head

    @property
    def group_size(self) -> int:
        return self.n_q_pad // self.n_kv_phys

    @property
    def kv_replication(self) -> float:
        return self.n_kv_phys / self.n_kv


def plan_heads(n_q: int, n_kv: int, tp: int) -> HeadPlan:
    if n_q % n_kv != 0:
        raise ValueError(f"n_q={n_q} not a multiple of n_kv={n_kv}")
    if n_kv % tp == 0:
        # native: no padding/replication needed
        return HeadPlan(
            n_q, n_kv, tp,
            n_q_pad=n_q,
            n_kv_phys=n_kv,
            h_per_slot=n_q // n_kv,
            q_slot_to_orig=tuple(range(n_q)),
            kv_slot_to_orig=tuple(range(n_kv)),
        )
    if n_kv > tp:
        raise ValueError(f"n_kv={n_kv} > tp={tp} but not divisible — unsupported")

    group = n_q // n_kv          # original q heads per kv head
    # smallest h (q heads per device) for which the group-by-group allocation
    # fits in tp devices: each kv group occupies ceil(group/h) devices.
    h = -(-n_q // tp)            # start at ceil: q heads per device
    while h <= group and n_kv * (-(-group // h)) > tp:
        h += 1
    h = min(h, group)
    n_q_pad = h * tp
    # allocate each kv group's q heads padded to a multiple of h
    q_layout: list[int] = []
    kv_layout: list[int] = []
    for kv in range(n_kv):
        heads = list(range(kv * group, (kv + 1) * group))
        while len(heads) % h != 0:
            heads.append(-1)     # pad head
        q_layout.extend(heads)
        kv_layout.extend([kv] * (len(heads) // h))
    if len(q_layout) > n_q_pad:
        raise ValueError(
            f"head plan infeasible: need {len(q_layout)} padded q slots > {n_q_pad}"
        )
    # fill remaining devices with pure-pad slots (kv slot duplicates last head)
    while len(q_layout) < n_q_pad:
        q_layout.extend([-1] * h)
        kv_layout.append(n_kv - 1)
    assert len(kv_layout) == tp, (len(kv_layout), tp)
    return HeadPlan(
        n_q, n_kv, tp,
        n_q_pad=n_q_pad,
        n_kv_phys=tp,
        h_per_slot=h,
        q_slot_to_orig=tuple(q_layout),
        kv_slot_to_orig=tuple(kv_layout),
    )


def validate_plan(plan: HeadPlan) -> None:
    """Every device's q heads must map to that device's kv slot."""
    h_dev = plan.n_q_pad // plan.tp
    group = plan.n_q // plan.n_kv
    for dev in range(plan.tp):
        kv_slots = set()
        for i in range(dev * h_dev, (dev + 1) * h_dev):
            q = plan.q_slot_to_orig[i]
            if q >= 0:
                kv_slots.add(q // group)
        dev_kv_slots = {
            plan.kv_slot_to_orig[s]
            for s in range(
                dev * plan.n_kv_phys // plan.tp, (dev + 1) * plan.n_kv_phys // plan.tp
            )
        }
        assert kv_slots <= dev_kv_slots, (dev, kv_slots, dev_kv_slots)
    # all original q heads present exactly once
    used = [q for q in plan.q_slot_to_orig if q >= 0]
    assert sorted(used) == list(range(plan.n_q))
