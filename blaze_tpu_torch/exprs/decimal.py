"""Spark-exact decimal arithmetic on the unscaled-int64 path (PyTorch).

A copy of blaze_tpu/exprs/decimal.py over torch tensors: a decimal(p<=18,
s) value is its unscaled int64; overflow of int64 or of the precision turns
the affected rows NULL (Spark's non-ANSI behaviour). Integer division is
floor division, as ``jnp //``, with the Java-truncation and HALF_UP
corrections written out.
"""

from __future__ import annotations

import torch


def _i64(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=like.device)


def floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def check_overflow(data, validity, precision: int):
    """Null out rows where |unscaled| >= 10^precision (spark_check_overflow)."""
    if precision >= 19:
        return data, validity
    bound = 10 ** precision
    ok = (data < bound) & (data > -bound)
    return data, validity & ok


def add(l_data, l_valid, r_data, r_valid):
    """Same-scale add with int64 overflow -> null."""
    s = l_data + r_data
    ovf = ((l_data >= 0) == (r_data >= 0)) & ((s >= 0) != (l_data >= 0)) & (l_data != 0)
    return s, l_valid & r_valid & ~ovf


def sub(l_data, l_valid, r_data, r_valid):
    return add(l_data, l_valid, -r_data, r_valid)


def _mul_overflows(a, b):
    p = a * b
    a_nz = torch.where(a == 0, torch.ones_like(a), a) if torch.is_tensor(a) \
        else (1 if a == 0 else a)
    bad = (a != 0) & (floordiv(p, a_nz) != b)
    return p, bad


def mul(l_data, l_valid, r_data, r_valid, rescale_down: int = 0):
    """Multiply unscaled values (result scale = s1+s2), optionally divide by
    10^rescale_down with HALF_UP rounding."""
    p, bad = _mul_overflows(l_data, r_data)
    validity = l_valid & r_valid & ~bad
    if rescale_down > 0:
        p = _div_half_up(p, 10 ** rescale_down)
    return p, validity


def _div_half_up(num, den):
    """Integer division with HALF_UP rounding (den > 0)."""
    q = floordiv(num, den)
    r = num - q * den
    neg = num < 0
    q_trunc = torch.where(neg & (r != 0), q + 1, q)
    r_trunc = num - q_trunc * den
    bump = (2 * torch.abs(r_trunc)) >= den
    return torch.where(bump, q_trunc + torch.where(neg, -1, 1), q_trunc)


def div(l_data, l_valid, r_data, r_valid, scale_adjust: int):
    """result_unscaled = l * 10^scale_adjust / r, HALF_UP; division by zero
    -> null (Spark non-ANSI)."""
    m = 10 ** scale_adjust if scale_adjust >= 0 else 1
    num, bad = _mul_overflows(l_data, _i64(m, l_data))
    if scale_adjust < 0:
        num = _div_half_up(l_data, 10 ** (-scale_adjust))
        bad = torch.zeros_like(l_valid)
    den_zero = r_data == 0
    den = torch.where(den_zero, torch.ones_like(r_data), r_data)
    q = _div_half_up(num * torch.where(den < 0, -1, 1), torch.abs(den))
    return q, l_valid & r_valid & ~bad & ~den_zero


def rescale(data, validity, from_scale: int, to_scale: int, to_precision: int):
    """Change scale with HALF_UP rounding; overflow -> null (decimal cast)."""
    if to_scale > from_scale:
        m = _i64(10 ** (to_scale - from_scale), data)
        out, bad = _mul_overflows(data, m)
        validity = validity & ~bad
    elif to_scale < from_scale:
        out = _div_half_up(data, 10 ** (from_scale - to_scale))
    else:
        out = data
    return check_overflow(out, validity, to_precision)
