"""JAX's random streams in plain PyTorch.

The JAX package draws every random number from ``jax.random`` keys: start
noise (``sim/env.py:reset``), EXP3 arms (``planning/bandits.py``), PPO's
starts, actions and minibatch order (``train/ppo.py``) and, through flax,
initial weights. This module draws the same numbers from the same keys, so
one ``--seed`` gives both packages the same draws.

It reproduces ``jax`` ``JAX_VERSION`` with its default PRNG, threefry2x32
under ``jax_threefry_partitionable=True`` (``jax/_src/prng.py``:
``threefry_2x32``, ``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``) and the samplers of
``jax/_src/random.py`` in f32.

- A key is a pair of 32-bit words in an ``int64`` tensor of shape (2,)
  (``key_data``'s layout). Every add and rotate is masked to 32 bits, and
  every draw is a whole-tensor operation on the key's device (or the device
  named where a key is made).
- Every draw equals JAX's (on its CPU backend) bit for bit: bits, keys,
  ``uniform``, the integer results (``choice``, ``categorical``,
  ``permutation``) and the draws that pass through ``erf_inv`` or ``log``
  (``normal``, ``truncated_normal``, ``gumbel``). For those, XLA's f32
  ``log``, ``log1p`` and ``erf_inv`` are written out here in torch ops in
  the order XLA:CPU evaluates them, with its fused multiply-adds rounded
  once (``_fma``) and its correctly rounded square root
  (``tests/test_torch_prng.py`` holds every draw to JAX's bits; the card
  gives the CPU's bits, ``chip_smoke.py`` phase 51).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

JAX_VERSION = "0.9.0"

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the count pairs ``(x0, x1)``
    under ``key``; int64 tensors holding 32-bit words."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def _hash_iota(key: torch.Tensor, shape: tuple):
    """``threefry2x32`` of the flat index of every element of ``shape``,
    split into its high and low words (``iota_2x32_shape``)."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key, i >> 32, i & _M)
    return b0.reshape(shape), b1.reshape(shape)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit words
    (a 64-bit seed; a negative one as JAX reads it with x64 on)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M, seed & _M], dtype=torch.int64,
                        device=device)


def key_data(key: torch.Tensor) -> np.ndarray:
    """``jax.random.key_data(key)``: the words as ``uint32``."""
    return key.cpu().numpy().astype(np.uint32)


def split(key: torch.Tensor, num=2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``num`` (an int or a shape) new keys,
    shape ``(*num, 2)``."""
    shape = _shape(num)
    return torch.stack(_hash_iota(key, shape), dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key, zero, zero + (int(data) & _M))
    return torch.stack([b0, b1])


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): int64 values in
    [0, 2**32)."""
    b0, b1 = _hash_iota(key, _shape(shape))
    return b0 ^ b1


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f32 tensors rounded once to f32, as XLA contracts it: the
    product is exact in f64, so the result is the fused one wherever the
    sum fits in 53 bits (where it does not, f64's own rounding could move
    the last place; no draw of the tests shows it)."""
    return (a.double() * b.double() + c.double()).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, XLA's (torch's f32 one on the
    CPU misses it in the last place for some values): the f64 root rounded
    to f32 is the correctly rounded f32 root."""
    return torch.sqrt(x.double()).float()


def uniform(key: torch.Tensor, shape=(), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: the top 23 bits as the mantissa of a
    float in [1, 2), less one, scaled to [minval, maxval) by one fused
    multiply-add (XLA contracts it)."""
    shape = _shape(shape)
    dev = key.device
    lo, hi = _f32(minval, dev), _f32(maxval, dev)
    m = (bits(key, shape) >> 9) | 0x3F800000
    floats = m.to(torch.int32).view(torch.float32) - 1.0
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def _hex32(h: str) -> float:
    """A float32 constant as LLVM IR prints it (a double's hex bits)."""
    return float(np.frombuffer(bytes.fromhex(h), ">f8")[0])


# XLA:CPU's f32 log (the Cephes polynomial of its vectorised math library),
# in the order its LLVM IR evaluates it: the constants, then
# log(2) = _LOG_Q2 + _LOG_Q1 split in two
_LOG_C = [_hex32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000")]
_LOG_Q1, _LOG_Q2 = _hex32("BF2BD01060000000"), _hex32("3FE6300000000000")
_SQRT_HALF = _hex32("3FE6A09E60000000")
_FLT_MIN = float(np.finfo(np.float32).tiny)
# log1p's rational branch for |x| < sqrt(2) - 1: numerator and denominator
_LOG1P_NUM = [_hex32(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000")]
_LOG1P_DEN = [1.0] + [_hex32(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000")]
_LOG1P_SMALL = _hex32("3FDA8279A0000000")


def _horner(x: torch.Tensor, coefs) -> torch.Tensor:
    p = torch.full_like(x, coefs[0])
    for c in coefs[1:]:
        p = _fma(p, x, torch.full_like(x, c))
    return p


def log(v: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log``, bit for bit: v = m 2^e with m in
    [sqrt(1/2), sqrt(2)), log(1 + (m - 1)) by the Cephes polynomial
    (contracted into FMAs as LLVM does), plus e log(2) in two parts."""
    a = torch.clamp(v, min=_FLT_MIN)
    b = a.view(torch.int32)
    e = ((b >> 23) - 127).to(torch.float32) + 1.0
    m = ((b & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    c = [torch.full_like(x, k) for k in _LOG_C]
    p0 = _fma(_fma(x, c[0], c[1]), x, c[2])
    p1 = _fma(_fma(x, c[3], c[4]), x, c[5])
    p2 = _fma(_fma(x, c[6], c[7]), x, c[8])
    y = _fma(_fma(p0, x3, p1), x3, p2)
    y = _fma(y, x3, e * _LOG_Q1)
    t = _fma(-x2, torch.full_like(x, 0.5), x)
    r = _fma(torch.full_like(e, _LOG_Q2), e, t + y)
    r = torch.where(v == math.inf, v, r)
    r = torch.where(v == 0.0, -math.inf, r)
    return torch.where(v < 0.0, math.nan, r)


def log1p(v: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log1p``: a rational function for |v| < sqrt(2) - 1,
    else ``log(1 + v)``."""
    x2 = v * v
    ratio = _horner(v, _LOG1P_NUM) / _horner(v, _LOG1P_DEN)
    near = v + _fma(x2, torch.full_like(v, -0.5), (v * x2) * ratio)
    return torch.where(v.abs() < _LOG1P_SMALL, near, log(v + 1.0))


# XLA's f32 erf_inv (chlo.erf_inv; M. Giles, "Approximating the erfinv
# function"): the polynomial coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
               1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``, term by term: w = -log1p(-x^2), a degree-8
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at +-1."""
    w = -log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _f32(_ERFINV_LT5[i], x.device),
                           _f32(_ERFINV_GE5[i], x.device))

    p = coef(0)
    for i in range(1, 9):
        p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in f32: sqrt(2) erf_inv(u), u uniform on
    (nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return _SQRT2 * erf_inv(u)


def truncated_normal(key: torch.Tensor, lower, upper,
                     shape=()) -> torch.Tensor:
    """``jax.random.truncated_normal`` in f32 on (lower, upper): erf_inv of a
    uniform between erf(lower/sqrt 2) and erf(upper/sqrt 2), clamped inside
    the open interval."""
    dev = key.device
    lower, upper = _f32(lower, "cpu"), _f32(upper, "cpu")
    sqrt2 = _f32(_SQRT2, "cpu")
    # the bounds' erf on the host, where torch's f32 erf is XLA's at +-2
    a, b = torch.erf(lower / sqrt2).to(dev), torch.erf(upper / sqrt2).to(dev)
    lower, upper = lower.to(dev), upper.to(dev)
    out = _SQRT2 * erf_inv(uniform(key, shape, a, b))
    inf = _f32(math.inf, dev)
    return torch.clamp(out, torch.nextafter(lower, inf),
                       torch.nextafter(upper, -inf))


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in f32: -log(-log(u)), u uniform
    on [tiny, 1)."""
    return -log(-log(uniform(key, shape, _FLT_MIN, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of logits + gumbel noise of the logits' shape."""
    g = gumbel(key, logits.shape).to(logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def choice(key: torch.Tensor, n: int, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, p=p)``: one index by inverse CDF, the
    first whose running sum of ``p`` reaches total * (1 - u). The sum is
    taken in order on the host (XLA:CPU's order; a card's scan adds in
    another); the index is returned on ``p``'s device."""
    device = p.device
    p = p.to("cpu", torch.float32)
    if p.shape != (n,):
        raise ValueError(f"p has shape {tuple(p.shape)}, not ({n},)")
    cum = torch.cumsum(p, dim=0)
    r = cum[-1] * (1.0 - uniform(key.cpu(), ()))
    return torch.searchsorted(cum, r.reshape(1))[0].to(device)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``range(n)`` through rounds of a
    stable sort on fresh 32-bit keys, as many rounds as make collisions
    unlikely (ceil(3 ln n / ln(2^32 - 1)))."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_M)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def param_key(key: torch.Tensor, module: str) -> torch.Tensor:
    """The key the first ``self.param`` of the flax submodule ``module`` (a
    child of the root) draws from in ``module.init(key, x)`` (flax 0.12.3,
    ``core/scope.py``): ``make_rng`` folds the scope path and the scope's
    counter, 1, into ``key`` by ``_fold_in_static``, the first 4 bytes
    (big-endian) of the SHA-1 of the name (UTF-8) and the counter's byte,
    without separators (flax's default). Every random parameter of the
    port's classes is the first of such a scope."""
    digest = hashlib.sha1(module.encode("utf-8") + b"\x01").digest()
    return fold_in(key, int.from_bytes(digest[:4], "big"))


def lecun_normal(key: torch.Tensor, shape) -> torch.Tensor:
    """flax's default Dense kernel (``lecun_normal``), f32: a normal
    truncated to [-2, 2], scaled by sqrt(1/fan_in)/0.87962566103423978
    with fan_in the second-to-last axis."""
    shape = _shape(shape)
    var = _f32(np.float32(1.0 / shape[-2]), key.device)
    std = _sqrt(var) / _f32(0.87962566103423978, key.device)
    return truncated_normal(key, -2, 2, shape) * std


def as_key(key_or_seed, device=None) -> torch.Tensor:
    """A key as given, or ``PRNGKey(seed)`` for an int seed."""
    if isinstance(key_or_seed, torch.Tensor):
        return key_or_seed if device is None else key_or_seed.to(device)
    return PRNGKey(key_or_seed, device=device)


__all__ = ["JAX_VERSION", "PRNGKey", "as_key", "bits", "categorical",
           "choice", "erf_inv", "fold_in", "gumbel", "key_data",
           "lecun_normal", "log", "log1p", "normal", "param_key",
           "permutation", "split", "threefry2x32", "truncated_normal",
           "uniform"]
