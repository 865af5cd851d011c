"""Plain training step of the P-frame codec: the cascaded rate-distortion
loss and AdamW with the gradient clamp of the published fork's harness
(DCVC-HEM/src/train_CANFVC_DMC.py:184-210, 605-631): per-sample lambda,
frames 1..cascade coded in turn from frame 0 with the DPB detached
between frames, mse as the sum over CHW / (H * W), straight-through
rounding, each gradient element clamped to +-5, then AdamW (betas 0.9 /
0.999, eps 1e-8, decoupled weight decay).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint


def cascade_loss(module, clip, lambdas, cascade: int, remat: bool = True):
    """Mean over frames 1..``cascade`` of the batch-mean of lambda * mse +
    bpp, for a clip [B, T, 3, H, W]."""
    B = clip.shape[0]
    one = torch.ones((B, 1, 1, 1), device=clip.device)
    qs = {k: one for k in ("mv_enc", "mv_dec", "y_enc", "y_dec")}
    dpb = {"ref_frame": clip[:, 0].contiguous(), "ref_feature": None,
           "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}
    total = 0.0
    for t in range(1, cascade + 1):
        x = clip[:, t].contiguous()

        def frame(x, dpb, t=t):
            return module(x, dpb, qs, t, "ste")

        if remat:
            out, bpp = torch.utils.checkpoint.checkpoint(
                frame, x, dpb, use_reentrant=False)
        else:
            out, bpp = frame(x, dpb)
        mse = ((x - out["ref_frame"]) ** 2).sum(dim=(1, 2, 3)) / (
            x.shape[2] * x.shape[3])
        total = total + (lambdas * mse + bpp).mean()
        dpb = {k: None if v is None else v.detach() for k, v in out.items()}
    return total / cascade


class AdamW:
    """AdamW with the elementwise gradient clamp, by hand."""

    def __init__(self, params, lr=1e-4, weight_decay=1e-2, clamp=5.0,
                 betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, self.wd, self.clamp = lr, weight_decay, clamp
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> list:
        """Updates the parameters; returns the clamped gradients."""
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        grads = []
        for p, m, v in zip(self.params, self.m, self.v):
            g = (torch.zeros_like(p) if p.grad is None
                 else p.grad.clamp(-self.clamp, self.clamp))
            grads.append(g)
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
            p.grad = None
        return grads
