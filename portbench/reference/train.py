"""Plain fp32 training of the reference DUSt3R: DUSt3R's confidence loss with the 'avg_dis' normalisation, its
gradient by autograd over blocks of rows, and AdamW, written from the published definitions.

    loss = sum over the two views of mean over pixels (conf * ||pred - gt|| - alpha * log conf),
           pred and gt each divided per pair by their mean distance to the origin over both views' pixels
    AdamW: m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
           p -= lr * (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd * p)

Every per-pixel term belongs to one pair, so the batch's gradient is the sum of the blocks' gradients of their
share of the mean: the blocks only bound the memory, they change nothing in the result.
"""

from typing import Dict, List

import torch

from portbench.reference.dust3r import fp32_exact

__all__ = ["pair_loss_sum", "ReferenceTrainer"]


def _avg_dis(p1: torch.Tensor, p2: torch.Tensor):
    "Both views divided per pair by the mean length of their points over both views' pixels."
    d = torch.cat([p1.norm(dim=-1).flatten(1), p2.norm(dim=-1).flatten(1)], dim=1).mean(dim=1)
    s = d.clamp(min=1e-8)[:, None, None, None]
    return p1 / s, p2 / s


def pair_loss_sum(outputs, gt1: torch.Tensor, gt2: torch.Tensor, alpha: float) -> torch.Tensor:
    "The sum over the rows' pixels of both views' confidence-weighted errors (not yet divided by the pixel count)."
    pts1, conf1, pts2, conf2 = outputs
    pts1, pts2 = _avg_dis(pts1, pts2)
    gt1, gt2 = _avg_dis(gt1, gt2)
    total = 0.0
    for pred, conf, gt in ((pts1, conf1[..., 0], gt1), (pts2, conf2[..., 0], gt2)):
        total = total + (conf * (pred - gt).norm(dim=-1) - alpha * torch.log(conf)).sum()
    return total


class ReferenceTrainer:
    """Steps of the reference model on host batches ({img1, img2: uint8 (P, H, W, 3); pts1, pts2: fp32}), the
    rows sent to ``device`` ``block`` pairs at a time. Records what the benchmark compares: each step's loss,
    each parameter's first gradient and its change since the start."""

    def __init__(self, model, device, lr: float, weight_decay: float, alpha: float, block: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.model, self.device, self.block = model.train(), device, block
        self.lr, self.wd, self.alpha, self.b1, self.b2, self.eps = lr, weight_decay, alpha, b1, b2, eps
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.start = [p.detach().clone() for p in self.params]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0
        self.losses: List[float] = []
        self.first_grad_norms: Dict[str, float] = {}

    def step(self, batch) -> float:
        P = len(batch["img1"])
        pixels = P * batch["img1"].shape[1] * batch["img1"].shape[2]
        grads = [torch.zeros_like(p) for p in self.params]
        loss = 0.0
        with fp32_exact():
            for r in range(0, P, self.block):
                rows = slice(r, r + self.block)
                dev = {k: torch.from_numpy(v[rows]).to(self.device) for k, v in batch.items()}
                share = pair_loss_sum(self.model(dev["img1"], dev["img2"]), dev["pts1"], dev["pts2"],
                                      self.alpha) / pixels
                for g, gp in zip(grads, torch.autograd.grad(share, self.params)):
                    g += gp
                loss += float(share.detach())
        if not self.first_grad_norms:
            self.first_grad_norms = {n: float(g.norm()) for n, g in zip(self.names, grads)}
        self._adamw(grads)
        self.losses.append(loss)
        return loss

    @torch.no_grad()
    def _adamw(self, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p -= self.lr * ((m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * p)

    def change_norms(self) -> Dict[str, float]:
        "Each parameter's ||p - p at the start||."
        return {n: float((p.detach() - s).norm()) for n, p, s in zip(self.names, self.params, self.start)}

