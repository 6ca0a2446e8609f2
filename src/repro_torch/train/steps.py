"""Train-step factory: the loss's value and gradient with microbatch
accumulation, the remat policy from the config, an optional Freivalds
SDC check of the head, and the AdamW update.

Port of src/repro/train/steps.py. The model's own parameters stay frozen
(`requires_grad=False`, as the serving path keeps them): each step builds
gradient leaves that share their storage (`lm.with_parameters`), takes
`torch.autograd.grad` through `lm_loss`, and returns a NEW model built
from the updated tensors, so a rejected step leaves the caller's model
as it was. On CUDA every attention layer's forward is the flash kernel
(under autograd: kernels/flash_grad.py).

The reference's step key is a seed or a `torch.Generator` here; only the
SDC probe draws from it.

Under sharding rules (distrib/sharding.py's `use_rules`, around the
step's calls) the parameters and the optimizer state are DTensors placed
by their specs, each microbatch is sharded over the batch axes, the step
runs under DTensor's `implicit_replication` (a plain tensor made inside
the model, a position range or a mask, counts as replicated), and the
metrics come back whole, as plain tensors.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..core.sdc import freivalds_residual
from ..distrib.sharding import distribute, full, plain_replicated
from ..models.lm import forward_hidden, lm_loss, with_parameters
from .optimizer import AdamWConfig, adamw_update

F32 = torch.float32
#: the profiler ranges of a step's parts, which a trace reads to split it
FORWARD_RANGE, BACKWARD_RANGE, OPTIMIZER_RANGE = (
    "train.forward", "train.backward", "train.optimizer")
#: the SDC probe: the first row and up to this many positions of a batch
SDC_PROBE_LEN = 128


def _microbatches(batch: dict, a: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % a:
        raise ValueError(f"batch {b} does not split into {a} microbatches")
    per = b // a
    return [{k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            for i in range(a)]


def _sharded(batch: dict) -> dict:
    """The batch's leaves sharded over the batch axes under the active
    rules (each rank holds the same full batch); as they are otherwise."""
    return {k: distribute(v, "batch", *([None] * (v.ndim - 1)))
            for k, v in batch.items()}


def loss_and_grads(model, batch: dict, cfg, *,
                   ce_chunk: int = 512) -> tuple[torch.Tensor, dict]:
    """(lm_loss under cfg.remat, its gradient by parameter name) of one
    batch; the model's parameters are left frozen and unchanged."""
    batch = _sharded(batch)
    work = with_parameters(model, dict(model.named_parameters()),
                           requires_grad=True)
    names, leaves = zip(*work.named_parameters())
    with record_function(FORWARD_RANGE):
        loss = lm_loss(work, batch, cfg, remat_policy=cfg.remat,
                       ce_chunk=ce_chunk)
    with record_function(BACKWARD_RANGE):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for n, p, g in zip(names, leaves, grads)}


def build_train_step(cfg, opt_cfg: AdamWConfig, *, sdc_check: bool = False,
                     ce_chunk: int = 512):
    """Returns train_step(model, opt_state, batch, key=0) -> (new model,
    new opt_state, metrics). metrics: 0-d tensors "loss", "grad_norm",
    "lr", and "sdc_residual" with sdc_check."""
    accum_dtype = F32 if cfg.optimizer_dtype == "float32" else torch.bfloat16

    def compute_grads(model, batch):
        a = cfg.grad_accum
        if a == 1:
            return loss_and_grads(model, batch, cfg, ce_chunk=ce_chunk)
        loss_sum, acc = 0.0, None
        for mb in _microbatches(batch, a):
            loss, g = loss_and_grads(model, mb, cfg, ce_chunk=ce_chunk)
            loss_sum = loss_sum + loss.to(F32)
            if acc is None:
                acc = {n: x.to(accum_dtype) for n, x in g.items()}
            else:
                acc = {n: acc[n] + g[n].to(accum_dtype) for n in acc}
        return loss_sum / a, {n: x / a for n, x in acc.items()}

    def train_step(model, opt_state, batch, key=0):
        with plain_replicated():
            new_model, new_opt, metrics = _step(model, opt_state, batch, key)
        return new_model, new_opt, {k: full(v) for k, v in metrics.items()}

    def _step(model, opt_state, batch, key):
        loss, grads = compute_grads(model, batch)
        metrics = {"loss": loss}
        if sdc_check:
            # verify the head's product on a probe slice (the paper's Q2 /
            # Freivalds as silent-data-corruption detection)
            with torch.no_grad():
                probe_batch = {k: v[:1, :SDC_PROBE_LEN] for k, v in batch.items()}
                hidden, _ = forward_hidden(model, probe_batch, cfg,
                                           remat_policy="none")
                probe = hidden[0].to(F32)
                head = model.lm_head.to(F32)
                metrics["sdc_residual"] = freivalds_residual(
                    probe, head, probe @ head, key)
        with record_function(OPTIMIZER_RANGE):
            new_params, new_opt, opt_metrics = adamw_update(
                dict(model.named_parameters()), grads, opt_state, opt_cfg)
        metrics.update(opt_metrics)
        return with_parameters(model, new_params), new_opt, metrics

    return train_step


def build_eval_step(cfg, *, ce_chunk: int = 512):
    """eval_step(model, batch) -> the loss (0-d f32), without autograd and
    without remat."""

    @torch.no_grad()
    def eval_step(model, batch):
        return lm_loss(model, batch, cfg, remat_policy="none",
                       ce_chunk=ce_chunk)

    return eval_step
