"""Float32 building blocks that round the way the JAX package does.

PyTorch's CPU kernels and XLA:CPU differ in a few elementwise ops:

- `torch.sqrt` on float32 CPU tensors (the vectorised AVX-512 path) is not
  always correctly rounded; XLA's is. `sqrt` here takes the square root in
  float64 on the CPU, which rounds to the correctly rounded float32 value.
  CUDA's float32 square root is IEEE-exact, so CUDA tensors use it directly.
- `x ** n` with an integer n > 3 calls `pow`; JAX's `integer_pow` multiplies
  by repeated squaring. `ipow` repeats JAX's multiplication order.
- `torch.sin`, `cos` and `exp` on float32 CPU tensors differ from XLA's
  in many more last bits than the correctly rounded values do; `sin`,
  `cos` and `exp` here round a float64 evaluation on the CPU.
- `jnp.cross` and `jnp.linalg.norm` on 3-vectors are fixed component
  formulas; `cross` and `norm3` write the same formulas out.
"""

from __future__ import annotations

import functools

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded elementwise square root of a float32 tensor."""
    if x.is_cuda or x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _rounded64(fn, x):
    if x.is_cuda or x.dtype != torch.float32:
        return fn(x)
    return fn(x.double()).float()


def sin(x: torch.Tensor) -> torch.Tensor:
    """sin, correctly rounded on the CPU (XLA:CPU's is within an ulp of
    that, where torch's vectorised float32 sin often is not)."""
    return _rounded64(torch.sin, x)


def cos(x: torch.Tensor) -> torch.Tensor:
    """cos, correctly rounded on the CPU (see sin)."""
    return _rounded64(torch.cos, x)


def exp(x: torch.Tensor) -> torch.Tensor:
    """exp, correctly rounded on the CPU (see sin)."""
    return _rounded64(torch.exp, x)


def ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for a positive python int n, in JAX integer_pow's order."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b).sum(-1) over a trailing axis of 3, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm3(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over a trailing axis of 3."""
    n = sqrt(dot3(x, x))
    return n[..., None] if keepdim else n


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis (jnp.cross's component order)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor on `like`'s device and dtype.

    Dividing a CUDA tensor by a python number multiplies by its float32
    reciprocal, which is not the correctly rounded quotient; dividing by a
    device tensor is. Functions whose float32 results a CUDA kernel must
    reproduce bit for bit divide by `scalar(...)`.
    """
    return torch.full((), value, dtype=like.dtype, device=like.device)


@functools.lru_cache(maxsize=None)
def const(values: tuple, device=None, dtype=torch.float32) -> torch.Tensor:
    """A small constant tensor, made once per device (no host-to-device copy
    inside a step). Callers must not write to it."""
    return torch.tensor(values, dtype=dtype, device=device)
