"""Helpers shared by the recurrent-layer wrappers (``gru.py``, ``lstm.py``):
the backward direction's time walk, the h_prev stream of the backward
products, argument checks and the f32-sum matmul of the layer backwards."""

from __future__ import annotations

import torch


def walk_index(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(T, B) time index of step s for each row of the backward direction:
    ``len - 1 - s`` inside the valid prefix, ``s`` past it. It is its own
    inverse, so it maps the walk back to time order as well."""
    s = torch.arange(t, device=lengths.device)[:, None]
    lens = lengths.to(s.dtype)[None, :]
    return torch.where(s < lens, lens - 1 - s, s)


def to_time_order(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(D, T, B, N) in walk order -> time order (direction 1 regathered)."""
    if a.shape[0] == 1:
        return a
    gather = idx[:, :, None].expand(-1, -1, a.shape[-1])
    return torch.stack([a[0], torch.gather(a[1], 0, gather)])


def valid_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(1, T, B, 1) bool: step t lies inside row b's length."""
    return (torch.arange(t, device=lengths.device)[:, None]
            < lengths[None, :])[None, :, :, None]


def h_prev_stream(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(D, T, B, H) layer outputs -> h_prev of each step in time order:
    h[t-1] for direction 0 (0 at t = 0), h[t+1] for direction 1 (0 where
    t + 1 is past the row's length)."""
    zero = torch.zeros_like(h[:1, :1])
    prev = [torch.cat([zero[0], h[0, :-1]])]
    if h.shape[0] == 2:
        t = h.shape[1]
        nxt = torch.cat([h[1, 1:], zero[0]])
        keep = (torch.arange(t, device=h.device)[:, None] + 1
                < lengths.to(h.device)[None, :])[:, :, None]
        prev.append(torch.where(keep, nxt, 0.0))
    return torch.stack(prev)


def same_device(where: str, dev: torch.device, **tensors) -> None:
    for name, a in tensors.items():
        if a.device != dev:
            raise ValueError(f"{where}: {name} on {a.device}, expected {dev}")


def check_layer(where: str, gates: int, dtypes: tuple, x: torch.Tensor,
                w_ih: torch.Tensor, b_ih: torch.Tensor, w_hh: torch.Tensor,
                b_hh: torch.Tensor, lengths: torch.Tensor
                ) -> tuple[int, int, int, int, int]:
    """Check a layer kernel's arguments -> (T, B, F, D, H).

    x (T, B, F), w_ih (D, F, G*H) and w_hh (D, H, G*H) share one operand
    type out of ``dtypes``; b_ih, b_hh (D, G*H); lengths (B,); D is 1 or 2;
    all on x's device."""
    dt = x.dtype
    if dt not in dtypes or w_ih.dtype != dt or w_hh.dtype != dt:
        raise TypeError(f"{where} kernel takes x, w_ih, w_hh all float32 "
                        f"or all bfloat16, got {x.dtype}, {w_ih.dtype}, "
                        f"{w_hh.dtype}")
    t, b, f_in = x.shape
    ndir, hidden, g = w_hh.shape
    if (g != gates * hidden or w_ih.shape != (ndir, f_in, g)
            or b_ih.shape != (ndir, g) or b_hh.shape != (ndir, g)
            or lengths.shape != (b,) or ndir not in (1, 2)):
        raise ValueError(f"{where}: inconsistent shapes "
                         f"x {tuple(x.shape)} w_ih {tuple(w_ih.shape)} "
                         f"w_hh {tuple(w_hh.shape)} b_ih {tuple(b_ih.shape)} "
                         f"b_hh {tuple(b_hh.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    same_device(where, x.device, w_ih=w_ih, b_ih=b_ih, w_hh=w_hh, b_hh=b_hh,
                lengths=lengths)
    return t, b, f_in, ndir, hidden


def check_scan(where: str, gates: int, dtypes: tuple, xp: torch.Tensor,
               b_ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
               lengths: torch.Tensor) -> tuple[int, int, int, int]:
    """Check a recurrence kernel's arguments -> (D, T, B, H).

    xp (D, T, B, G*H) and w_hh (D, H, G*H) share one operand type out of
    ``dtypes``; b_ih, b_hh (D, G*H); lengths (B,); D is 1 or 2; all on
    xp's device."""
    dt = xp.dtype
    if dt not in dtypes or w_hh.dtype != dt:
        raise TypeError(f"{where} kernel takes xp and w_hh both float32 or "
                        f"both bfloat16, got {xp.dtype}, {w_hh.dtype}")
    ndir, t, b, g = xp.shape
    hidden = w_hh.shape[1]
    if (g != gates * hidden or w_hh.shape != (ndir, hidden, g)
            or b_ih.shape != (ndir, g) or b_hh.shape != (ndir, g)
            or lengths.shape != (b,) or ndir not in (1, 2)):
        raise ValueError(f"{where}: inconsistent shapes "
                         f"xp {tuple(xp.shape)} w_hh {tuple(w_hh.shape)} "
                         f"b_ih {tuple(b_ih.shape)} b_hh {tuple(b_hh.shape)} "
                         f"lengths {tuple(lengths.shape)}")
    same_device(where, xp.device, b_ih=b_ih, w_hh=w_hh, b_hh=b_hh,
                lengths=lengths)
    return ndir, t, b, hidden


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 sums and an f32 result, operands in their own type
    (bf16 products are exact in f32)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()
