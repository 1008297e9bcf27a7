"""Worker selection policy: a cost per worker and a softmax draw.

Port of dynamo_tpu/router/scheduling.py `KvRouterConfig` and
`WorkerSelector.select`:

    cost(worker) = prefill_load_scale * (new blocks + queued prefill blocks)
                   + decode blocks
    new blocks   = total blocks - overlap_weight * credit

where the credit counts the blocks the worker holds on the device in
full and those in lower tiers in part. Selection samples
softmax(-cost / temperature); temperature 0 is the argmin. The KV
router passes the object-tier overlaps (`obj_overlaps`, from the workers'
tier="obj" events), each candidate's link class to the best G2 holder
(`link_class`, from `kv_slice` metadata) and, when a cost source is
bound, measured onboard seconds a block (`tier_costs`: the frontend's
FleetObserver `onboard_costs`, from the workers' fleet digests), so a
credit without a measurement is its constant prior. With `audit`, each
candidate's cost breakdown is appended (the routing audit's records:
overlaps, credit weights and whether each lower tier's weight was
measured or the prior, the cost, and which one was chosen).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from dynamo_tpu_torch.router.protocols import OverlapScores
from dynamo_tpu_torch.router.sequences import ActiveSequences

Worker = Tuple[int, int]


@dataclass
class KvRouterConfig:
    """Routing knobs (the reference's KvRouterConfig)."""

    prefill_load_scale: float = 1.5  # prefill tokens cost more than decode
    temperature: float = 0.0  # 0 = deterministic argmin
    # scale on the overlap credit (--kv-overlap-score-weight): > 1 is
    # cache-greedier (lower TTFT), < 1 load-flatter
    overlap_weight: float = 1.0
    # credit per block by tier: device hits count fully, lower tiers in part
    device_credit: float = 1.0
    host_credit: float = 0.6
    # a prefix in a PEER's lower tier: dearer than local host DRAM
    remote_credit: float = 0.3
    # peer-pull priors by link class (same slice / across slices)
    remote_ici_credit: float = 0.45
    remote_dcn_credit: float = 0.15
    obj_credit: float = 0.15  # the fleet-shared object tier
    # recompute cost of one block of prefill, the unit a measured onboard
    # cost is priced against
    recompute_block_s: float = 0.00064
    seed: Optional[int] = None

    def credit_fraction(self, s_per_block: float) -> float:
        """A tier's credit weight from its onboard seconds per block: the
        fraction of a block's recompute cost that onboarding saves."""
        denom = max(1e-9, self.recompute_block_s)
        return max(0.0, 1.0 - min(1.0, float(s_per_block) / denom))

    def prior_seconds(self, credit: float) -> float:
        """Inverse of credit_fraction: the seconds per block a constant
        prior credit implies."""
        return (1.0 - min(1.0, max(0.0, credit))) * self.recompute_block_s


class WorkerSelector:
    def __init__(self, config: Optional[KvRouterConfig] = None):
        self.config = config or KvRouterConfig()
        self._rng = random.Random(self.config.seed)

    def select(
        self,
        workers: List[Worker],
        total_blocks: int,
        overlaps: OverlapScores,
        sequences: ActiveSequences,
        host_overlaps: Optional[Dict[Worker, int]] = None,
        tier_costs: Optional[Dict[Worker, Dict[str, float]]] = None,
        link_class: Optional[Dict[Worker, str]] = None,
        obj_overlaps: Optional[Dict[Worker, int]] = None,
        audit: Optional[List[dict]] = None,
    ) -> Tuple[Worker, int]:
        """Returns (worker, device overlap blocks). Raises if no workers.

        `tier_costs` (measured onboard seconds per block, by worker and
        tier), `link_class` (each candidate's link to the best holding
        peer, "ici" or "dcn") and `obj_overlaps` (object-tier residency)
        price the lower tiers; missing entries fall back, leg by leg, to
        the config's constant priors."""
        if not workers:
            raise RuntimeError("no workers available for KV routing")
        cfg = self.config
        costs: List[float] = []
        cluster_host = max((host_overlaps or {}).values(), default=0)
        cluster_obj = max((obj_overlaps or {}).values(), default=0)
        for w in workers:
            dev = overlaps.scores.get(w, 0)
            host = (host_overlaps or {}).get(w, 0)
            tc = (tier_costs or {}).get(w) or {}
            link = (link_class or {}).get(w)
            # every leg in one unit (seconds per block): measured values
            # as they are, cold legs at their prior credit's seconds
            if "host" in tc:
                host_s = tc["host"]
                host_w, host_src = cfg.credit_fraction(host_s), "measured"
            else:
                host_s = cfg.prior_seconds(cfg.host_credit)
                host_w, host_src = cfg.host_credit, "prior"
            r_key = None
            if link is not None and f"remote_{link}" in tc:
                r_key = f"remote_{link}"
            elif "remote" in tc:
                r_key = "remote"
            remote_src = "measured" if r_key is not None else "prior"
            if r_key is not None:
                remote_leg_s = tc[r_key]
            else:
                prior_c = {"ici": cfg.remote_ici_credit,
                           "dcn": cfg.remote_dcn_credit}.get(link, cfg.remote_credit)
                # the prior covers the whole pull (fetch + host import):
                # take the host leg out so it is not paid twice
                remote_leg_s = max(0.0, cfg.prior_seconds(prior_c)
                                   - cfg.prior_seconds(cfg.host_credit))
            remote_w = cfg.credit_fraction(remote_leg_s + host_s)
            obj_w = (cfg.credit_fraction(tc["obj"] + host_s) if "obj" in tc
                     else cfg.obj_credit)
            obj_src = "measured" if "obj" in tc else "prior"
            credit = cfg.device_credit * dev + host_w * max(0, host - dev)
            # blocks a peer's lower tier holds can be pulled across workers
            credit += remote_w * max(0, cluster_host - max(dev, host))
            # and blocks beyond every run are one object-tier read away
            credit += obj_w * max(0, cluster_obj - max(dev, host, cluster_host))
            new_blocks = max(0.0, total_blocks - cfg.overlap_weight * credit)
            prefill = new_blocks + sequences.prefill_blocks(w)
            decode = sequences.decode_blocks(w)
            costs.append(cfg.prefill_load_scale * prefill + decode)
            if audit is not None:
                audit.append({
                    "worker": list(w), "overlap_blocks": dev,
                    "host_overlap_blocks": host,
                    "obj_overlap_blocks": (obj_overlaps or {}).get(w, 0),
                    "link_class": link, "credit": round(credit, 3),
                    "host_credit_w": round(host_w, 3),
                    "remote_credit_w": round(remote_w, 3),
                    "obj_credit_w": round(obj_w, 3),
                    "credit_src": {"host": host_src, "remote": remote_src,
                                   "obj": obj_src},
                    "new_blocks": round(new_blocks, 3),
                    "prefill_blocks": round(prefill, 3),
                    "decode_blocks": round(decode, 3),
                    "cost": round(costs[-1], 3),
                })

        if cfg.temperature <= 0.0:
            best = min(range(len(workers)), key=lambda i: (costs[i], workers[i]))
        else:
            # softmax over -cost / temperature (shifted for stability)
            m = min(costs)
            logits = [-(c - m) / cfg.temperature for c in costs]
            mx = max(logits)
            ws = [math.exp(x - mx) for x in logits]
            r = self._rng.random() * sum(ws)
            acc = 0.0
            best = len(workers) - 1
            for i, wgt in enumerate(ws):
                acc += wgt
                if r <= acc:
                    best = i
                    break
        w = workers[best]
        if audit is not None:
            for i, entry in enumerate(audit[-len(workers):]):
                entry["chosen"] = i == best
        return w, overlaps.scores.get(w, 0)
