"""Float arithmetic whose every result is the same at any batch size.

A library reduction, matrix product or linear solve picks its kernel, and
with it the order of its sums, from the whole tensor's shape: cuBLAS,
cuSOLVER and ATen's reduction kernels each choose their splits by the
number of outputs and the batch count. So a session's bits in a batch of B
may differ from its bits alone. Every function here computes each output
element by elementwise operations whose order is fixed by the shape of one
batch element: a sum of k terms is the terms added left to right, or, for a
long axis, in a binary tree of halves (``tree_sum``). A session's result is
then the same at any B, on a card and on the CPU, and the session-axis
step of ``parallel/multi_session.py`` runs its floats through these.

The elementwise transcendental functions the step calls (log, pow, sin,
cos) are the same on a card for every element. On the CPU ATen runs them
vectorized over whole vectors and scalar over a tail, which may round
differently: there a session's bits equal its own at B = 1 where a
session's rows are whole vectors (capacities a multiple of 32) and B is
under 16.

Leading axes broadcast as in PyTorch; the trailing shapes are the ones
each function names.
"""
from __future__ import annotations

import torch

from orbslam2_tpu_torch.geometry import se3


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the last axis, its terms added in index order."""
    p = a * b
    out = p[..., 0]
    for i in range(1, p.shape[-1]):
        out = out + p[..., i]
    return out


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over axis ``dim`` (dropped) as a binary tree: the axis is
    padded with zeros to a power of two, then halved by adding its second
    half to its first until one element is left."""
    n = x.shape[dim]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        pad = list(x.shape)
        pad[dim] = size - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    while size > 1:
        size //= 2
        x = x.narrow(dim, 0, size) + x.narrow(dim, size, size)
    return x.squeeze(dim)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., m, k] @ [..., k, n], the k products added in index order."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for i in range(1, a.shape[-1]):
        out = out + a[..., :, i:i + 1] * b[..., i:i + 1, :]
    return out


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., m, k] @ [..., k] -> [..., m]."""
    return dot(m, v[..., None, :])


def apply(tcw: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Points [..., N, 3] by poses [..., 4, 4]: R p + t per point."""
    return matvec(tcw[..., None, :3, :3], points) + tcw[..., None, :3, 3]


def camera_center(tcw: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 3]: -R^T t."""
    return -matvec(tcw[..., :3, :3].transpose(-1, -2), tcw[..., :3, 3])


def exp(xi: torch.Tensor) -> torch.Tensor:
    """``se3.exp`` with its sums and products in fixed order."""
    rho, phi = xi[..., :3], xi[..., 3:]
    a, b, c = se3._so3_coeffs(dot(phi, phi))
    k = se3.hat(phi)
    kk = matmul(k, k)
    eye = se3._eye_like(k)
    rot = eye + a[..., None, None] * k + b[..., None, None] * kk
    v = eye + b[..., None, None] * k + c[..., None, None] * kk
    return se3.from_rt(rot, matvec(v, rho))


def retract(tcw: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update exp(xi) * T, as ``se3.retract``."""
    return matmul(exp(xi), tcw)


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with a x = b for a [..., n, n] with a nonzero pivot at each step
    (symmetric positive definite, as a damped normal matrix is) and b
    [..., n], by Gauss-Jordan elimination without pivoting: row k's
    multiple is taken from every other row in turn, then x = b / diag(a)."""
    n = a.shape[-1]
    for k in range(n):
        f = a[..., :, k] / a[..., k:k + 1, k]
        f[..., k].fill_(0.0)
        a = a - f[..., :, None] * a[..., k:k + 1, :]
        b = b - f * b[..., k:k + 1]
    return b / torch.diagonal(a, dim1=-2, dim2=-1)
