"""Train, prefill and greedy serve steps (built per config)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, current_rules, lay_out
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.spans import span
from repro_torch.optim import adamw


def make_train_step(cfg: ModelConfig, hp: adamw.Hyper, grad_placements=None):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics), with `params` and `opt_state` updated in place.

    batch: {"tokens", "labels"}, (B, S) integer tensors on the params'
    device, and for an encoder-decoder "enc_feats" (B, F, d) f32; step:
    int.  With hp.microbatches > 1 every entry of the batch is split along
    dim 0 into that many microbatches, run one after the other; their f32
    gradients and losses are summed and divided by the count, and their
    metrics averaged.  Then the gradients are clipped to hp.clip in global
    norm and AdamW is applied.  metrics: loss, ce, aux, grad_norm, lr (0-dim
    tensors).

    On DTensor parameters under the dry run's axis rules, each gradient is
    laid out as its optimizer state `opt_state["m"]` is, so that the
    weight-gradient reductions are reduce-scatters into that layout (where
    the optimizer's own ops would leave the reduction's kind to DTensor,
    which picks it by torch version; the reference's `grad_shardings`).
    grad_placements, an optional tree of DTensor placement lists matching
    params, names another layout: the dry run's tests lay the gradients
    out as the parameters to weigh the default's wire bytes against.
    Elsewhere the gradients are left as autograd gives them.
    """

    def grad_fn(params, batch, layout):
        # detached views of the leaves (no copy) that autograd tracks, so
        # the caller's tensors are left as they are
        tracked = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(tracked)
        loss, metrics = T.forward_train(cfg, tracked, batch)
        grads = torch.autograd.grad(loss, leaves)
        by_leaf = {id(p): g for p, g in zip(tree_leaves(params), grads)}
        grads = tree_map(lambda p: by_leaf[id(p)], params)
        if layout is not None:
            grads = tree_map(lay_out, grads, layout)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads)

    def train_step(params, opt_state, batch, step):
        layout = grad_placements
        if layout is None and current_rules() is not None:
            layout = tree_map(lambda m: list(m.placements), opt_state["m"])
        if hp.microbatches > 1:
            mb = hp.microbatches

            def split(x):
                return x.reshape((mb, x.shape[0] // mb) + x.shape[1:])

            batches = tree_map(split, batch)
            grads = tree_map(lambda p: torch.zeros(p.shape, device=p.device), params)
            loss_sum = torch.zeros((), device=batch["tokens"].device)
            ms = []
            for i in range(mb):
                loss_i, m_i, g_i = grad_fn(params, tree_map(lambda x: x[i], batches), layout)
                tree_map(lambda a, g: a.add_(g.float()), grads, g_i)
                loss_sum = loss_sum + loss_i
                ms.append(m_i)
                del g_i     # free this microbatch's gradients before the next backward
            grads = tree_map(lambda g: g.div_(mb), grads)
            loss = loss_sum / mb
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        else:
            loss, metrics, grads = grad_fn(params, batch, layout)

        grads, gnorm = adamw.clip_by_global_norm(grads, hp.clip)
        params, opt_state = adamw.update(grads, opt_state, params, step, hp)
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm, lr=adamw.schedule(hp, step))
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        with span("repro.prefill"):
            return T.prefill(cfg, params, batch["tokens"], batch.get("enc_feats"))

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: (params, caches, tokens, pos_t) ->
    (next_tokens, caches), the caches updated in place."""

    @torch.no_grad()
    def serve_step(params, caches, tokens, pos_t):
        with span("repro.decode"):
            logits, new_caches = T.decode_step(cfg, params, caches, tokens, pos_t)
            # under the dry run's rules the argmax reads the vocab whole (a
            # no-op elsewhere)
            logits = constrain(logits, ("batch", None, None))
            with span("repro.argmax"):
                nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            return nxt, new_caches

    return serve_step
