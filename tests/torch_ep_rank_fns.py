"""Functions the expert-parallel tests run on every rank of a world
(parallel/group.py TPGroup.run_on_ranks): importable without JAX, so the
spawned ranks load only torch and the port."""

import torch

from dynamo_tpu_torch.ops.moe_dispatch import EP_COUNTS, moe_ep
from dynamo_tpu_torch.parallel.mesh import cut_leaf


def rank_moe_ep(group, arrays, k, capacity_factor, routing):
    """moe_ep on this rank's slice of whole numpy operands (x [T, E], the
    router, the expert stacks [n, E, F] / [n, F, E], the selection bias or
    None): the rank's token block by its expert coordinate, its experts and
    their F columns by its expert and model coordinates. Returns (expert
    coordinate, the block's output, this rank's dispatch counts)."""
    x, wr, wg, wu, wd, bias = (None if a is None else torch.from_numpy(a) for a in arrays)
    c, mesh = group.coords, group.mesh
    t = x.shape[0] // mesh.expert
    e = c["expert"]

    def part(w, name):  # a stack as one layer of the params tree
        return cut_leaf(name, w[None], c["model"], mesh.model, e, mesh.expert)[0]

    for key in EP_COUNTS:
        EP_COUNTS[key] = 0
    out = moe_ep(x[e * t:(e + 1) * t], wr, part(wg, "we_gate"), part(wu, "we_up"),
                 part(wd, "we_down"), group.expert, k, capacity_factor,
                 model_group=group.model, router_bias=bias, **routing)
    return e, out.numpy(), dict(EP_COUNTS)
