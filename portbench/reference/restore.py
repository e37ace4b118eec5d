"""Plain reference of the two-phase restoration (paper §4.3), in PyTorch.

Written from the paper's description and the semantics the configuration
states, not from the port: it imports nothing of the port or of the JAX
package.  It takes a noisy frame and returns the restored frame and the
number of sweeps:

1. Detection, an adaptive median filter with windows escalating from 3×3
   to (2·kmax+1)²: at the first level whose window median lies strictly
   between the window's minimum and maximum, the pixel is noise unless it
   lies strictly between them too; a noisy pixel takes that median.  A
   pixel no level decides is noise and takes the last level's median.
2. Restoration from the repaired frame: each sweep moves every noisy pixel
   to (β · med4 + mean4) / (β + 1) of its four neighbours (med4 the mean of
   the middle two of the four sorted values) and keeps every other pixel at
   the repaired value; the sweeps repeat until the largest absolute change
   of a sweep is below ``tol``, or ``max_iters`` sweeps have run (at least
   one runs).

Neighbours past the frame's edge mirror it without repeating the edge
(numpy's ``reflect``).  The arithmetic runs in ``dtype``, float32 for the
configuration, with the operations in the order written above; the
control runs it in bfloat16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad(a: torch.Tensor, k: int) -> torch.Tensor:
    """Mirror ``k`` cells on every side, the edge not repeated."""
    return F.pad(a[None, None], (k, k, k, k), mode="reflect")[0, 0]


def _window(p: torch.Tensor, k: int, pad: int, m: int, n: int):
    """The (2k+1)² values around each pixel, stacked on a leading axis,
    from a frame padded by ``pad`` >= k."""
    o = pad - k
    return torch.stack([p[o + i:o + i + m, o + j:o + j + n]
                        for i in range(2 * k + 1) for j in range(2 * k + 1)])


def detect(frame: torch.Tensor, kmax: int = 3):
    """(noise mask as 0/1 in the frame's dtype, repaired frame)."""
    m, n = frame.shape
    p = _pad(frame, kmax)
    x = frame
    decided = torch.zeros_like(x, dtype=torch.bool)
    noise = torch.zeros_like(x, dtype=torch.bool)
    repl = x
    med = x
    for k in range(1, kmax + 1):
        w = _window(p, k, kmax, m, n)
        srt = torch.sort(w, dim=0).values
        mn, med, mx = srt[0], srt[w.shape[0] // 2], srt[-1]
        del w, srt
        here = (med > mn) & (med < mx)
        is_noise = ~((x > mn) & (x < mx))
        new = here & ~decided
        noise = torch.where(new, is_noise, noise)
        repl = torch.where(new & is_noise, med, repl)
        decided = decided | here
    noise = noise | ~decided
    repl = torch.where(~decided, med, repl)
    return noise.to(x.dtype), repl


def restore(repaired: torch.Tensor, mask: torch.Tensor, *, beta: float,
            tol: float, max_iters: int):
    """(restored frame, sweeps run) from the repaired frame and its mask,
    in their dtype."""
    dt, dev = repaired.dtype, repaired.device
    b = torch.tensor(beta, dtype=dt, device=dev)
    b1 = torch.tensor(beta + 1.0, dtype=dt, device=dev)
    tol_t = torch.tensor(tol, dtype=dt, device=dev)
    m, n = repaired.shape
    noisy = mask > 0
    a = repaired
    it = 0
    while True:
        p = _pad(a, 1)
        up, down = p[0:m, 1:n + 1], p[2:m + 2, 1:n + 1]
        left, right = p[1:m + 1, 0:n], p[1:m + 1, 2:n + 2]
        srt = torch.sort(torch.stack([up, down, left, right]), dim=0).values
        med4 = 0.5 * (srt[1] + srt[2])
        mean4 = (up + down + left + right) / 4.0
        prop = (b * med4 + mean4) / b1
        new = torch.where(noisy, prop, repaired)
        r = (new - a).abs().max()
        a = new
        it += 1
        if bool(r < tol_t) or it >= max_iters:
            return a, it


def restore_frame(frame: torch.Tensor, cfg: dict, dtype=torch.float32):
    """Detection then restoration of one noisy frame under the
    configuration ``cfg`` (its ``detect`` and ``restore`` groups), computed
    in ``dtype``.  Returns (restored frame, sweeps)."""
    mask, repaired = detect(frame.to(dtype), cfg["detect"]["kmax"])
    r = cfg["restore"]
    return restore(repaired, mask, beta=r["beta"], tol=r["tol"],
                   max_iters=r["max_iters"])
