"""GAN training steps for the vocoders (HiFT, BigVGAN, VITS).  Port of
cosyvoice_tpu/train/gan.py.

The generator's loss: adversarial + 2 x feature matching + 45 x the
multi-resolution mel L1 + 1 x TPR (tau 0.04), plus the f0 L1 (HiFT), the
aux-mel reconstruction (BigVGAN) or the KL term (VITS, on a random segment
of the waveform); the discriminator's: LSGAN + TPR.  Each step takes its
gradients with torch.autograd.grad over its own net's parameters alone, so
the generator's step never moves the discriminator and the
discriminator's never moves the generator, and updates them with its own
optimizer (train/optim.py).  The generator runs under torch.no_grad()
inside the discriminator step (the JAX package's stop_gradient).  The
executor hands both steps of a batch a generator of the same (seed, step),
so the generator draws the same noise, dropout masks and VITS segment in
both, as the JAX package's two steps share one key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from cosyvoice_tpu_torch.models.discriminator import (discriminator_loss, feature_loss,
                                                      generator_loss, mel_l1_loss, tpr_loss)
from cosyvoice_tpu_torch.models.vits import segments, vits_kl_loss
from cosyvoice_tpu_torch.nn.dropout import dropout_generator
from cosyvoice_tpu_torch.train.optim import Transform, global_norm
from cosyvoice_tpu_torch.train.step import TrainState, trainable_params


@dataclass(frozen=True)
class GanLossWeights:
    mel: float = 45.0
    feat_match: float = 2.0
    tpr: float = 1.0
    tpr_tau: float = 0.04


def _adversarial(discriminator_apply, d_model, real, fake, weights: GanLossWeights,
                 mel_transforms):
    """The terms both vocoder families share -> (weighted sum, terms)."""
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = discriminator_apply(d_model, real, fake)
    terms = {"loss_gen": generator_loss(y_d_gs), "loss_fm": feature_loss(fmap_rs, fmap_gs),
             "loss_mel": mel_l1_loss(real, fake, mel_transforms),
             "loss_tpr": (tpr_loss(y_d_rs, y_d_gs, weights.tpr_tau) if weights.tpr > 0
                          else real.new_zeros(()))}
    total = (terms["loss_gen"] + weights.feat_match * terms["loss_fm"]
             + weights.mel * terms["loss_mel"] + weights.tpr * terms["loss_tpr"])
    return total, terms


def _discriminator_terms(discriminator_apply, d_model, real, fake, weights: GanLossWeights):
    y_d_rs, y_d_gs, _, _ = discriminator_apply(d_model, real, fake)
    loss_disc = discriminator_loss(y_d_rs, y_d_gs)
    loss_tpr = (tpr_loss(y_d_rs, y_d_gs, weights.tpr_tau) if weights.tpr > 0
                else real.new_zeros(()))
    return loss_disc + weights.tpr * loss_tpr, {"loss_disc": loss_disc, "loss_tpr_d": loss_tpr}


def make_gan_loss_fns(generator_apply: Callable, discriminator_apply: Callable,
                      mel_transforms: Sequence[Callable],
                      weights: GanLossWeights = GanLossWeights()):
    """generator_apply(g_model, batch, gen) -> (wav, aux), aux the f0 [B, T]
    (HiFT), the aux mel [B, T', M] (BigVGAN) or None;
    discriminator_apply(d_model, real, fake) -> (y_d_rs, y_d_gs, fmap_rs,
    fmap_gs).  Returns (generator_loss_fn(g_model, d_model, batch, gen),
    discriminator_loss_fn(d_model, g_model, batch, gen)), each -> (loss,
    terms)."""

    def generator_loss_fn(g_model, d_model, batch, gen):
        real = batch["speech"]
        fake, aux = generator_apply(g_model, batch, gen)
        fake = fake[:, :real.shape[-1]]
        loss, terms = _adversarial(discriminator_apply, d_model, real, fake, weights,
                                   mel_transforms)
        zero = real.new_zeros(())
        terms["loss_f0"] = terms["loss_mel_recon"] = zero
        if aux is not None and "pitch_feat" in batch:
            terms["loss_f0"] = torch.mean(torch.abs(aux - batch["pitch_feat"]))
        if aux is not None and "speech_feat" in batch and aux.dim() == 3:
            T = min(aux.shape[1], batch["speech_feat"].shape[1])
            terms["loss_mel_recon"] = torch.mean((aux[:, :T] - batch["speech_feat"][:, :T]) ** 2)
        return loss + terms["loss_f0"] + terms["loss_mel_recon"], terms

    def discriminator_loss_fn(d_model, g_model, batch, gen):
        real = batch["speech"]
        with torch.no_grad():
            fake, _ = generator_apply(g_model, batch, gen)
        return _discriminator_terms(discriminator_apply, d_model, real,
                                    fake[:, :real.shape[-1]], weights)

    return generator_loss_fn, discriminator_loss_fn


def make_vits_loss_fns(generator_apply: Callable, discriminator_apply: Callable,
                       mel_transforms: Sequence[Callable], hop_length: int,
                       segment_size: int, weights: GanLossWeights = GanLossWeights(),
                       kl_weight: float = 1.0):
    """VITS: generator_apply(g_model, batch, gen) -> (wav segment, (ids,
    x_mask, y_mask, z, z_p, m_p, logs_p, m_q, logs_q)) (VitsDecoder.forward);
    the real side is the matching segment of the speech (ids * hop_length,
    clamped as the generator's segment is), and the KL term is added."""

    def real_segments(batch, ids):
        return segments(batch["speech"], ids * hop_length, segment_size)

    def generator_loss_fn(g_model, d_model, batch, gen):
        fake, (ids, _, y_mask, _, z_p, m_p, logs_p, _, logs_q) = \
            generator_apply(g_model, batch, gen)
        real = real_segments(batch, ids)
        fake = fake[:, :real.shape[-1]]
        loss, terms = _adversarial(discriminator_apply, d_model, real, fake, weights,
                                   mel_transforms)
        terms["loss_kl"] = vits_kl_loss(z_p, logs_q, m_p, logs_p, y_mask)
        return loss + kl_weight * terms["loss_kl"], terms

    def discriminator_loss_fn(d_model, g_model, batch, gen):
        with torch.no_grad():
            fake, (ids, *_) = generator_apply(g_model, batch, gen)
        real = real_segments(batch, ids)
        return _discriminator_terms(discriminator_apply, d_model, real,
                                    fake[:, :real.shape[-1]], weights)

    return generator_loss_fn, discriminator_loss_fn


def _apply(state: TrainState, tx: Transform, loss, params: dict) -> dict:
    """Gradients of `loss` over `params` alone (zeros where none flows),
    then the optimizer's update applied in place -> the raw gradients."""
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    with torch.no_grad():
        plain = {k: p.detach() for k, p in params.items()}
        updates, state.opt_state = tx.update(grads, state.opt_state, plain)
        if updates is not None:
            torch._foreach_add_(list(plain.values()), [updates[k] for k in plain])
    state.step += 1
    return grads


def make_gan_steps(generator_loss_fn, discriminator_loss_fn, tx_g: Transform,
                   tx_d: Transform):
    """-> (g_step(g_state, (d_model, batch), gen), d_step(d_state, g_model,
    batch, gen)), each -> (state, metrics) with the state updated in place;
    the generator's metrics add `loss` and `grad_norm`, the
    discriminator's `loss`."""

    def g_step(g_state: TrainState, d_model_batch, gen: torch.Generator):
        d_model, batch = d_model_batch
        g_state.model.train()
        with dropout_generator(gen):
            loss, terms = generator_loss_fn(g_state.model, d_model, batch, gen)
        loss = loss.float()
        grads = _apply(g_state, tx_g, loss, trainable_params(g_state.model))
        metrics = {k: v.detach() for k, v in terms.items()}
        metrics.update(loss=loss.detach(), grad_norm=global_norm(grads))
        return g_state, metrics

    def d_step(d_state: TrainState, g_model, batch, gen: torch.Generator):
        g_model.train()
        d_state.model.train()
        with dropout_generator(gen):
            loss, terms = discriminator_loss_fn(d_state.model, g_model, batch, gen)
        loss = loss.float()
        _apply(d_state, tx_d, loss, trainable_params(d_state.model))
        metrics = {k: v.detach() for k, v in terms.items()}
        metrics.update(loss=loss.detach())
        return d_state, metrics

    return g_step, d_step
