"""Piecewise rational-quadratic spline flows (the VITS stochastic-duration
plumbing; the shipped recipes do not run it).

Port of cosyvoice_tpu/ops/splines.py (the reference's transforms_sdp.py):
a monotone rational-quadratic spline over [left, right] x [bottom, top]
with softmax-normalised bin widths and heights (each at least its minimum)
and softplus knot derivatives; the unconstrained form adds identity linear
tails outside [-tail_bound, tail_bound].  As in the JAX package, every
element is evaluated with its input clamped into the interval and a
`where` keeps the identity outside, in place of the reference's boolean
indexing.  The bin search keeps the JAX rule: the count of knots at or
below the input, the last knot raised by 1e-6, minus one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations: torch.Tensor, inputs: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    locs = torch.cat([bin_locations[..., :-1], bin_locations[..., -1:] + eps], dim=-1)
    return (inputs[..., None] >= locs).sum(dim=-1) - 1


def _knots(unnormalized: torch.Tensor, min_bin: float, lo: float, hi: float):
    """-> (knot positions [..., n+1] from lo to hi, bin sizes [..., n])."""
    n = unnormalized.shape[-1]
    size = min_bin + (1 - min_bin * n) * torch.softmax(unnormalized, dim=-1)
    cum = (hi - lo) * F.pad(torch.cumsum(size, dim=-1), (1, 0)) + lo
    edge = torch.ones_like(cum[..., :1])
    cum = torch.cat([edge * lo, cum[..., 1:-1], edge * hi], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(inputs, unnormalized_widths, unnormalized_heights,
                              unnormalized_derivatives, inverse=False, left=0.0, right=1.0,
                              bottom=0.0, top=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                              min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                              min_derivative=DEFAULT_MIN_DERIVATIVE):
    """-> (outputs, logabsdet), each shaped like `inputs`."""
    num_bins = unnormalized_widths.shape[-1]
    cumwidths, widths = _knots(unnormalized_widths, min_bin_width, left, right)
    cumheights, heights = _knots(unnormalized_heights, min_bin_height, bottom, top)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)
    bin_idx = bin_idx.clamp(0, num_bins - 1)[..., None]

    def take(a):
        return torch.gather(a, -1, bin_idx)[..., 0]

    input_cumwidths = take(cumwidths[..., :-1])
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights[..., :-1])
    input_delta = take(heights / widths)
    input_derivatives = take(derivatives[..., :-1])
    input_derivatives_plus_one = take(derivatives[..., 1:])
    input_heights = take(heights)

    d_sum = input_derivatives + input_derivatives_plus_one - 2 * input_delta
    if inverse:
        a = ((inputs - input_cumheights) * d_sum
             + input_heights * (input_delta - input_derivatives))
        b = input_heights * input_derivatives - (inputs - input_cumheights) * d_sum
        c = -input_delta * (inputs - input_cumheights)
        discriminant = b ** 2 - 4 * a * c
        root = (2 * c) / (-b - torch.sqrt(discriminant.clamp_min(0.0)))
        outputs = root * input_bin_widths + input_cumwidths
        tomt = root * (1 - root)
        denominator = input_delta + d_sum * tomt
        derivative_numerator = input_delta ** 2 * (
            input_derivatives_plus_one * root ** 2 + 2 * input_delta * tomt
            + input_derivatives * (1 - root) ** 2)
        logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
        return outputs, -logabsdet
    theta = (inputs - input_cumwidths) / input_bin_widths
    tomt = theta * (1 - theta)
    numerator = input_heights * (input_delta * theta ** 2 + input_derivatives * tomt)
    denominator = input_delta + d_sum * tomt
    outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta ** 2 * (
        input_derivatives_plus_one * theta ** 2 + 2 * input_delta * tomt
        + input_derivatives * (1 - theta) ** 2)
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, logabsdet


def unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
        inverse=False, tails="linear", tail_bound=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=DEFAULT_MIN_BIN_HEIGHT, min_derivative=DEFAULT_MIN_DERIVATIVE):
    """The spline on [-tail_bound, tail_bound], the identity outside (its
    end derivatives pinned to 1, so the tails join smoothly)."""
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented.")
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.expm1(1 - min_derivative))
    ud = F.pad(unnormalized_derivatives, (1, 1))
    edge = torch.full_like(ud[..., :1], constant)
    ud = torch.cat([edge, ud[..., 1:-1], edge], dim=-1)
    out_in, lad_in = rational_quadratic_spline(
        inputs.clamp(-tail_bound, tail_bound), unnormalized_widths, unnormalized_heights, ud,
        inverse=inverse, left=-tail_bound, right=tail_bound, bottom=-tail_bound,
        top=tail_bound, min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)
    return (torch.where(inside, out_in, inputs),
            torch.where(inside, lad_in, torch.zeros_like(lad_in)))


def piecewise_rational_quadratic_transform(
        inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
        inverse=False, tails=None, tail_bound=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=DEFAULT_MIN_BIN_HEIGHT, min_derivative=DEFAULT_MIN_DERIVATIVE):
    """The bounded spline (tails None) or the one with linear tails."""
    fn = rational_quadratic_spline if tails is None else \
        unconstrained_rational_quadratic_spline
    kwargs = {} if tails is None else {"tails": tails, "tail_bound": tail_bound}
    return fn(inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
              inverse=inverse, min_bin_width=min_bin_width, min_bin_height=min_bin_height,
              min_derivative=min_derivative, **kwargs)
