"""Spark-semantics casts of device columns (non-ANSI: invalid conversions
yield NULL), in PyTorch.

The counterpart of blaze_tpu/exprs/cast.py ``cast_dev``, op for op:

- decimal -> decimal rescales (HALF_UP), overflow -> NULL; decimal -> int
  truncates toward zero and wraps to the target; decimal -> float divides
  the unscaled value by 10^scale as IEEE divides (a device-tensor divisor,
  ``compiler._decimal_to_f64``); decimal -> bool is ``!= 0``;
- int/bool -> decimal multiplies by 10^scale with int64 overflow -> NULL,
  then checks the precision; float -> decimal rounds HALF_UP, and a
  non-finite or oversized value is NULL;
- float -> int has Java semantics: NaN -> 0, saturation at the target's
  bounds, the out-of-range lanes masked before the convert (the convert
  is undefined there, in torch as in XLA);
- -> bool is ``!= 0``; date -> timestamp multiplies by the microseconds of
  a day, timestamp -> date and timestamp -> long (seconds) floor-divide,
  long -> timestamp multiplies by 10^6;
- everything else widens, or narrows wrapping as Java does.

The casts from and to strings (the reference's ``cast_host``) read host
columns, which the port does not have yet (``host_cast_error``).
"""

from __future__ import annotations

import torch

from blaze_tpu_torch.exprs import decimal as dec
from blaze_tpu_torch.ir import types as T

_INT_TYPES = (T.Int8Type, T.Int16Type, T.Int32Type, T.Int64Type)
_FLOAT_TYPES = (T.Float32Type, T.Float64Type)

US_PER_DAY = 86_400_000_000
US_PER_SECOND = 1_000_000


def is_int(dt: T.DataType) -> bool:
    return isinstance(dt, _INT_TYPES)


def is_float(dt: T.DataType) -> bool:
    return isinstance(dt, _FLOAT_TYPES)


def decimal_to_f64(data: torch.Tensor, scale: int) -> torch.Tensor:
    """unscaled / 10^scale in float64, divided as IEEE divides: the
    divisor is a device tensor (CUDA torch multiplies by the reciprocal of
    a Python scalar divisor, which rounds 35 / 100 to 0.35000000000000003)."""
    den = torch.full((), float(10 ** scale), dtype=torch.float64, device=data.device)
    return data.to(torch.float64) / den


def cast_dev(data: torch.Tensor, validity: torch.Tensor, frm: T.DataType,
             to: T.DataType):
    """Cast a device value (a plane, or a 0-d literal); returns (data,
    validity)."""
    if frm == to:
        return data, validity
    tdt = T.torch_dtype(to)
    if isinstance(frm, T.DecimalType):
        if isinstance(to, T.DecimalType):
            return dec.rescale(data, validity, frm.scale, to.scale, to.precision)
        if is_int(to):
            m = 10 ** frm.scale
            scaled = dec.floordiv(data, m)
            r = data - scaled * m
            trunc = torch.where((r != 0) & (data < 0), scaled + 1, scaled)
            return trunc.to(tdt), validity
        if is_float(to):
            return decimal_to_f64(data, frm.scale).to(tdt), validity
        if isinstance(to, T.BooleanType):
            return data != 0, validity
        raise NotImplementedError(f"cast decimal -> {to!r}")
    if isinstance(to, T.DecimalType):
        if is_int(frm) or isinstance(frm, T.BooleanType):
            v = data.to(torch.int64)
            if to.scale > 0:
                out, bad = dec._mul_overflows(
                    v, torch.full((), 10 ** to.scale, dtype=torch.int64, device=v.device))
                validity = validity & ~bad
            else:
                out = v
            return dec.check_overflow(out, validity, to.precision)
        if is_float(frm):
            scaled = data.to(torch.float64) * float(10 ** to.scale)
            rounded = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                                  torch.ceil(scaled - 0.5))
            ok = torch.isfinite(scaled) & (torch.abs(rounded) < float(2 ** 63))
            out = torch.where(ok, rounded, 0.0).to(torch.int64)
            return dec.check_overflow(out, validity & ok, to.precision)
        raise NotImplementedError(f"cast {frm!r} -> decimal")
    if is_float(frm) and is_int(to):
        info = torch.iinfo(tdt)
        lo, hi = info.min, info.max
        x = torch.trunc(torch.nan_to_num(data.to(torch.float64), nan=0.0))
        max_f, min_f = float(hi), float(lo)
        in_bounds = (x > min_f) & (x < max_f)
        xi = torch.where(in_bounds, x, 0.0).to(tdt)
        out = torch.where(x >= max_f, torch.full((), hi, dtype=tdt, device=x.device),
                          torch.where(x <= min_f,
                                      torch.full((), lo, dtype=tdt, device=x.device), xi))
        return out, validity
    if isinstance(to, T.BooleanType):
        return data != 0, validity
    if isinstance(frm, T.DateType) and isinstance(to, T.TimestampType):
        return data.to(torch.int64) * US_PER_DAY, validity
    if isinstance(frm, T.TimestampType) and isinstance(to, T.DateType):
        return dec.floordiv(data, US_PER_DAY).to(torch.int32), validity
    if isinstance(frm, T.TimestampType) and is_int(to):
        return dec.floordiv(data, US_PER_SECOND).to(tdt), validity
    if is_int(frm) and isinstance(to, T.TimestampType):
        return data.to(torch.int64) * US_PER_SECOND, validity
    if tdt is not None:
        return data.to(tdt), validity
    raise NotImplementedError(f"device cast {frm!r} -> {to!r}")


def host_cast_error(frm: T.DataType, to: T.DataType) -> NotImplementedError:
    """The error for a cast the reference runs on the host (from and to
    strings, and between host columns): it needs the string plane."""
    return NotImplementedError(
        f"cast {frm!r} -> {to!r} reads or writes a string or host column, which the "
        "PyTorch package has no plane for yet (ROADMAP.md Queue 1 item 6b)")
