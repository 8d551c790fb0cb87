"""The collectives of the parallel layer, and the autograd rules of those
that sit inside a differentiated computation.

Every rank runs the same program on its own part of the data, and its
backward pass computes its share of the global gradient: the training
step sums the shares over the ranks (``all_reduce``). Under that rule

- ``gather`` (each rank's block → the blocks of every rank, in rank
  order) has as backward the sum over ranks of the gathered cotangent,
  of which each rank keeps its own block;
- ``take`` (a rank's block of a tensor that every rank holds alike) has
  as backward the cotangent placed in that block, zeros elsewhere;
- ``global_sum`` (a value → its sum over the ranks, alike on every rank)
  has the identity as backward: its cotangent is whole on every rank, as a
  loss term's is (each rank's backward starts from the same loss);
- ``psum`` (the same sum, for a value that every rank's own rows depend
  on, as an ODE solver's error norm sets the step size of every rank's
  state) has the same sum as backward (JAX's ``psum`` transpose): its
  cotangent is, on each rank, only that rank's share.

On a data × sequence mesh the ranks of a "seq" group hold the same rows
and run the same program on them, so each holds the whole gradient of
those rows (the step sums over "data" alone). Only a sequence-parallel
attention parts them, with rules that keep that whole:

- ``split`` (a rank's block of a tensor alike on every rank, whose
  cotangent every rank holds whole) has as backward the blocks'
  cotangents gathered, whole again on every rank;
- ``unsplit`` (the blocks of every rank gathered, the result alike on
  every rank and so its cotangent) has as backward this rank's block of
  that cotangent;
- ``all_to_all`` (JAX's tiled ``all_to_all``: block j of ``split_dim``
  to rank j, the blocks received concatenated along ``concat_dim`` in
  rank order) has as backward the inverse exchange.

Backends. NCCL takes every collective on CUDA tensors. Gloo, the CPU
backend, also serves several processes on one card, where NCCL refuses
two ranks a device; ``GLOO_CUDA`` lists the collectives that
``ProcessGroupGloo`` runs on CUDA tensors, and the others (send and
receive among them) are staged through host memory, by this table and
nothing else: ``staging`` names what a group stages.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the collectives that ProcessGroupGloo took on CUDA tensors on an H100
# under torch 2.11 (a send / receive pair of CUDA tensors aborted the
# process: "writev: Bad address"; gloo has no all-to-all of CUDA tensors)
GLOO_CUDA = frozenset({"all_reduce", "broadcast", "all_gather"})


def _staged(op: str, x: torch.Tensor, group) -> bool:
    return (x.is_cuda and dist.get_backend(group) == "gloo"
            and op not in GLOO_CUDA)


def staging(group, device: torch.device) -> list:
    """The collectives that ``group`` stages through host memory for
    tensors on ``device`` (empty under NCCL, and on the CPU)."""
    probe = torch.empty(0, device=device)
    return sorted(op for op in ("all_reduce", "broadcast", "all_gather",
                                "all_to_all", "send_recv")
                  if _staged(op, probe, group))


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group``, in place; returns ``x``."""
    if _staged("all_reduce", x, group):
        host = x.cpu()
        dist.all_reduce(host, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=group)
    return x


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of the rank ``src`` of ``group`` (None: the world), in place on
    every rank; returns ``x``."""
    src = src if group is None else dist.get_global_rank(group, src)
    if _staged("broadcast", x, group):
        host = x.cpu()
        dist.broadcast(host, src, group=group)
        x.copy_(host)
    else:
        dist.broadcast(x, src, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all), concatenated along ``dim`` in
    rank order; no gradient."""
    x = x.contiguous()
    staged = _staged("all_gather", x, group)
    src = x.cpu() if staged else x
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def ring_shift(tensors: list, group) -> list:
    """Send each tensor to the next rank of ``group`` (rank order, wrapping)
    and return those received from the previous one. The tensors travel
    as one flat buffer of their common dtype."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    staged = _staged("send_recv", flat, group)
    send = flat.cpu() if staged else flat
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (me + 1) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (me - 1) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    recv = recv.to(flat.device)
    out, at = [], 0
    for t in tensors:
        out.append(recv[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    send = torch.stack(torch.split(x, x.shape[split_dim] // n,
                                   dim=split_dim)).contiguous()
    staged = _staged("all_to_all", send, group)
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.to(x.device).unbind(0), dim=concat_dim)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.group)
        return _block(g, ctx.group, ctx.dim).contiguous(), None, None


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.shape = group, dim, x.shape
        return _block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        _block(out, ctx.group, ctx.dim).copy_(g)
        return out, None, None


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Unsplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g.contiguous(), ctx.group, concat_dim, split_dim),
                None, None, None)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Differentiable ``all_gather`` along ``dim``: this rank's block
    becomes block ``rank`` of the result."""
    return _Gather.apply(x, group, dim)


def take(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Differentiable: this rank's block (``rank`` of the group's size) of a
    tensor that every rank of ``group`` holds alike."""
    return _Take.apply(x, group, dim)


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable: the sum of ``x`` over ``group``, alike on every rank;
    each rank's gradient is its own share's."""
    return _GlobalSum.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable: the sum of ``x`` over ``group``, alike on every rank,
    where each rank holds a share of the result's cotangent (a value that
    steers every rank's own computation); the backward sums the shares."""
    return _Psum.apply(x, group)


def split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Differentiable: this rank's block along ``dim`` of a tensor that every
    rank of ``group`` holds alike with its whole cotangent (the rows that
    a data group's sequence ranks share); the backward gathers the blocks'
    cotangents."""
    return _Split.apply(x, group, dim)


def unsplit(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Differentiable: the blocks of every rank of ``group`` along ``dim``,
    alike on every rank, whose cotangent every rank then holds whole; the
    backward keeps this rank's block of it (``split``'s inverse)."""
    return _Unsplit.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Differentiable all-to-all over ``group``: ``x`` cut into the group's
    size of blocks along ``split_dim`` (which must divide), block j sent
    to rank j, the blocks received concatenated along ``concat_dim`` in
    rank order. NCCL's is native (and captured in a CUDA graph); gloo's
    on CUDA tensors goes through host memory. The backward is the inverse
    exchange."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)
