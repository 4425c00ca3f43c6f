"""One gloo rank of `tests/test_torch_port_full_mesh.py`:

    python tests/torch_port_full_mesh_rank.py {ce|steps} JOB OUT

with torchrun's variables set (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
JOB is a `torch.save`d dict the test wrote; the rank writes its results to
`OUT.<rank>`. Imports torch and the port only.

- `ce`: `parallel/vocab_ce.sharded_full_ce` over the WORLD group, each rank
  holding its row block of the decoder's emb and bias; the loss, the hits,
  the gradients of a given cotangent, and `gathered_full_scores`;
- `steps`: the port's Trainer on a (1, world) mesh (psum exchange, every
  table row-sharded), the given MFP steps with the given draws; the steps'
  metrics and the gathered state dict.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def ce(job, world: int, rank: int) -> dict:
    from map_tpu_torch.parallel.mesh import Group
    from map_tpu_torch.parallel.sharding import SHARD_ATTR, shard_rows
    from map_tpu_torch.parallel.vocab_ce import gathered_full_scores, sharded_full_ce

    group = Group(list(range(world)), rank, dist.group.WORLD)
    s = shard_rows(job["emb"].shape[0], world, rank)
    blocks = []
    for name in ("emb", "bias"):
        p = torch.nn.Parameter(job[name][s.lo:s.lo + s.rows].clone())
        setattr(p, SHARD_ATTR, s)
        blocks.append(p)
    emb, bias = blocks
    x = job["inputs"].clone().requires_grad_()
    loss, hit = sharded_full_ce(x, emb, bias, job["target"], group)
    (loss * job["cot"]).sum().backward()
    with torch.inference_mode():
        eval_loss, eval_hit = sharded_full_ce(x.detach(), emb, bias, job["target"], group)
    return dict(lo=s.lo, loss=loss.detach(), hit=hit, d_x=x.grad, d_emb=emb.grad,
                d_bias=bias.grad, eval_loss=eval_loss, eval_hit=eval_hit,
                scores=gathered_full_scores(x.detach(), emb, bias, group))


def steps(job) -> dict:
    from map_tpu_torch import models
    from map_tpu_torch.train.trainer import Trainer

    cfg = job["config"]
    model = models.from_config(cfg)
    model.load_state_dict(job["state"])
    trainer = Trainer(model, cfg, job["args"], dataset=None, device="cpu")
    trainer.build_steps(job["total_steps"])
    metrics = []
    for batch, draws in zip(job["batches"], job["draws"]):
        m = trainer.train_step(batch, draws)
        metrics.append([m[k].item() for k in ("loss", "count", "acc_count")])
    return dict(metrics=metrics, state=trainer._full_state_dict(),
                mesh=[trainer.mesh.num_data, trainer.mesh.num_model],
                shards=sorted(trainer._shards))


def main() -> int:
    from map_tpu_torch.parallel.mesh import maybe_init_distributed

    mode, job_path, out = sys.argv[1:4]
    world = maybe_init_distributed("gloo")
    rank = dist.get_rank()
    job = torch.load(job_path, weights_only=False)
    res = ce(job, world, rank) if mode == "ce" else steps(job)
    torch.save(res, f"{out}.{rank}")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
