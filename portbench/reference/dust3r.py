"""
Plain fp32 PyTorch DUSt3R, the benchmark's reference for the DUSt3R cells.

Written from the published architecture (naver/dust3r, CroCo v2; UniCeption's
module layout for the state-dict keys), with nothing of the program under test:
no custom kernel, no cache, no batching trick. Every product runs in fp32 with
TF32 off (:func:`fp32_exact` sets the flags while a call runs).

    uint8 frames -> (x / 255 - 0.5) / 0.5
      -> CroCo ViT encoder: 16x16 patch conv, pre-norm blocks (qkv with bias,
         2D RoPE on q and k, exact GELU MLP), final LayerNorm (eps 1e-6)
      -> two-view decoder: linear 1024 -> 768, per view and depth a block of
         self-attention, cross-attention to the other view's tokens of the
         previous depth (normalised by norm_y) and an MLP, then a LayerNorm
      -> per view a linear head (1x1 conv to 4 * 16 * 16, pixel shuffle) or a
         DPT head (hooks: encoder output, decoder depths 5 and 8 unnormalised,
         the normalised decoder output)
      -> pointmap xyz / |xyz| * expm1(|xyz|), confidence 1 + exp(c)

The state-dict keys are the ones the benchmark draws its weights under
(``encoder.enc_blocks.{i}.attn.qkv.weight``, ``info_sharing.multi_view_branches
.{v}.{i}...``, ``head{1,2}.linear``, ``dpt_feature_head{1,2}.input_process...``,
``dpt_regressor_head{1,2}...``).
"""

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ReferenceDUSt3R", "fp32_exact", "normalize_frames", "Linear"]


@contextlib.contextmanager
def fp32_exact():
    "TF32 off for matmuls and cuDNN convolutions while the block runs."
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def normalize_frames(frames_u8: torch.Tensor) -> torch.Tensor:
    "uint8 (B, H, W, 3) -> fp32 (B, 3, H, W) with DUSt3R's normalisation (mean 0.5, std 0.5)."
    return (frames_u8.permute(0, 3, 1, 2).float() / 255.0 - 0.5) / 0.5


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor (its largest magnitude to e4m3's 448), back in
    t's dtype; the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


class Linear(nn.Linear):
    """nn.Linear; with ``lowp = "fp8"`` its input and weight are rounded to float8 e4m3 first (the control of the
    training cells: the trunk's products one precision below the configured bf16)."""

    lowp = None

    def forward(self, x):
        if self.lowp == "fp8":
            return F.linear(fp8_e4m3(x), fp8_e4m3(self.weight), self.bias)
        return super().forward(x)


def grid_positions(batch: int, hp: int, wp: int, device) -> torch.Tensor:
    "(B, hp * wp, 2) integer (y, x) of the patch grid in row-major order."
    y, x = torch.meshgrid(torch.arange(hp, device=device), torch.arange(wp, device=device), indexing="ij")
    return torch.stack([y.reshape(-1), x.reshape(-1)], dim=-1)[None].expand(batch, -1, -1)


def rope_1d(t: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """Rotary embedding over the last axis of ``t`` (B, H, N, d) at integer positions ``pos`` (B, N): the halves
    [u | v] rotate by pos / base ** (2 j / d), CroCo's ``RoPE2D.apply_rope1d``."""
    d = t.shape[-1]
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, device=t.device, dtype=torch.float64) / d))
    ang = (pos.to(torch.float64)[..., None] * inv_freq).to(torch.float32)  # (B, N, d / 2)
    cos, sin = torch.cat([ang.cos()] * 2, -1)[:, None], torch.cat([ang.sin()] * 2, -1)[:, None]
    u, v = t[..., : d // 2], t[..., d // 2 :]
    return t * cos + torch.cat([-v, u], dim=-1) * sin


def rope_2d(t: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    "2D RoPE: the first half of each head rotates by the y position, the second by x."
    y, x = t.chunk(2, dim=-1)
    return torch.cat([rope_1d(y, pos[..., 0], base), rope_1d(x, pos[..., 1], base)], dim=-1)


def attend(q, k, v, qpos, kpos, base):
    "q (B, H, Nq, D), k and v (B, H, Nk, D): RoPE on q and k, then softmax(q k^T / sqrt(D)) v."
    q, k = rope_2d(q, qpos, base), rope_2d(k, kpos, base)
    scores = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.softmax(scores, dim=-1) @ v


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = Linear(dim, hidden), Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SelfAttention(nn.Module):
    def __init__(self, dim, heads, base):
        super().__init__()
        self.heads, self.base = heads, base
        self.qkv, self.proj = Linear(dim, 3 * dim), Linear(dim, dim)

    def forward(self, x, pos):
        B, N, C = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads).permute(2, 0, 3, 1, 4)
        out = attend(q, k, v, pos, pos, self.base)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class CrossAttention(nn.Module):
    def __init__(self, dim, heads, base):
        super().__init__()
        self.heads, self.base = heads, base
        self.projq, self.projk, self.projv = Linear(dim, dim), Linear(dim, dim), Linear(dim, dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, y, xpos, ypos):
        B, N, C = x.shape
        split = lambda t: t.reshape(B, t.shape[1], self.heads, C // self.heads).transpose(1, 2)  # noqa: E731
        out = attend(split(self.projq(x)), split(self.projk(y)), split(self.projv(y)), xpos, ypos, self.base)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class EncoderBlock(nn.Module):
    def __init__(self, dim, heads, base):
        super().__init__()
        self.norm1, self.norm2 = nn.LayerNorm(dim, eps=1e-6), nn.LayerNorm(dim, eps=1e-6)
        self.attn, self.mlp = SelfAttention(dim, heads, base), Mlp(dim, 4 * dim)

    def forward(self, x, pos):
        x = x + self.attn(self.norm1(x), pos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    def __init__(self, dim, heads, base):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim, eps=1e-6) for _ in range(3))
        self.norm_y = nn.LayerNorm(dim, eps=1e-6)
        self.attn, self.cross_attn = SelfAttention(dim, heads, base), CrossAttention(dim, heads, base)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x, y, xpos, ypos):
        x = x + self.attn(self.norm1(x), xpos)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(y), xpos, ypos)
        return x + self.mlp(self.norm3(x))


class ResidualConvUnit(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv1, self.conv2 = nn.Conv2d(ch, ch, 3, 1, 1), nn.Conv2d(ch, ch, 3, 1, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    def __init__(self, ch, has_res1=True):
        super().__init__()
        if has_res1:
            self.resConfUnit1 = ResidualConvUnit(ch)
        self.resConfUnit2 = ResidualConvUnit(ch)
        self.out_conv = nn.Conv2d(ch, ch, 1)

    def forward(self, x, res=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = F.interpolate(self.resConfUnit2(x), scale_factor=2, mode="bilinear", align_corners=True)
        return self.out_conv(x)


class DPTFeature(nn.Module):
    "DPT's four hooks -> resize (4x deconv, 2x deconv, identity, stride-2 conv) -> 3x3 projections -> fusion."

    def __init__(self, in_dims, layer_dims, feature_dim):
        super().__init__()
        d, ld = in_dims, layer_dims
        resize = [
            nn.Sequential(nn.Conv2d(d[0], ld[0], 1), nn.ConvTranspose2d(ld[0], ld[0], 4, 4)),
            nn.Sequential(nn.Conv2d(d[1], ld[1], 1), nn.ConvTranspose2d(ld[1], ld[1], 2, 2)),
            nn.Sequential(nn.Conv2d(d[2], ld[2], 1)),
            nn.Sequential(nn.Conv2d(d[3], ld[3], 1), nn.Conv2d(ld[3], ld[3], 3, 2, 1)),
        ]
        self.input_process = nn.ModuleList(
            [nn.Sequential(r, nn.Conv2d(ld[i], feature_dim, 3, 1, 1, bias=False)) for i, r in enumerate(resize)])
        self.scratch = nn.Module()
        for i in (1, 2, 3):
            setattr(self.scratch, f"refinenet{i}", FusionBlock(feature_dim))
        self.scratch.refinenet4 = FusionBlock(feature_dim, has_res1=False)

    def forward(self, feats):
        layers = [proc(f) for proc, f in zip(self.input_process, feats)]
        s = self.scratch
        path = s.refinenet4(layers[3])[:, :, : layers[2].shape[2], : layers[2].shape[3]]
        path = s.refinenet3(path, layers[2])
        path = s.refinenet2(path, layers[1])
        return s.refinenet1(path, layers[0])


class DPTRegressor(nn.Module):
    def __init__(self, feature_dim, out_dim):
        super().__init__()
        hidden = feature_dim // 2
        self.conv1 = nn.Conv2d(feature_dim, hidden, 3, 1, 1)
        self.conv2 = nn.Sequential(nn.Conv2d(hidden, hidden, 3, 1, 1), nn.ReLU(), nn.Conv2d(hidden, out_dim, 1))

    def forward(self, x, size):
        return self.conv2(F.interpolate(self.conv1(x), size=size, mode="bilinear", align_corners=True))


class LinearHead(nn.Module):
    def __init__(self, dim, out_dim, patch):
        super().__init__()
        self.patch = patch
        self.linear = nn.Conv2d(dim, out_dim * patch * patch, 1)

    def forward(self, x):
        return F.pixel_shuffle(self.linear(x), self.patch)


class ReferenceDUSt3R(nn.Module):
    """DUSt3R from a configuration dict (``arch`` of a benchmark configuration file): ``enc_embed_dim``,
    ``enc_depth``, ``enc_num_heads``, ``dec_embed_dim``, ``dec_depth``, ``dec_num_heads``, ``patch_size``,
    ``rope_freq``, ``head`` ("linear" or "dpt"), ``output_dim`` and, for DPT, ``dpt_feature_dim``,
    ``dpt_layer_dims`` and ``dpt_decoder_hooks`` (the decoder depths, 0-based, whose unnormalised tokens feed
    hooks 1 and 2)."""

    def __init__(self, arch: dict):
        super().__init__()
        C, Cd, P = arch["enc_embed_dim"], arch["dec_embed_dim"], arch["patch_size"]
        base = float(arch["rope_freq"])
        self.arch, self.patch = arch, P
        self.encoder = nn.Module()
        self.encoder.patch_embed = nn.Module()
        self.encoder.patch_embed.proj = nn.Conv2d(3, C, P, P)
        self.encoder.enc_blocks = nn.ModuleList(
            [EncoderBlock(C, arch["enc_num_heads"], base) for _ in range(arch["enc_depth"])])
        self.encoder.enc_norm = nn.LayerNorm(C, eps=1e-6)
        self.info_sharing = nn.Module()
        self.info_sharing.proj_embed = Linear(C, Cd)
        self.info_sharing.multi_view_branches = nn.ModuleList(
            [nn.ModuleList([DecoderBlock(Cd, arch["dec_num_heads"], base) for _ in range(arch["dec_depth"])])
             for _ in range(2)])
        self.info_sharing.norm = nn.LayerNorm(Cd, eps=1e-6)
        out_dim = arch["output_dim"]
        if arch["head"] == "linear":
            self.head1, self.head2 = LinearHead(Cd, out_dim, P), LinearHead(Cd, out_dim, P)
        else:
            fd, ld = arch["dpt_feature_dim"], arch["dpt_layer_dims"]
            dims = [C, Cd, Cd, Cd]
            self.dpt_feature_head1, self.dpt_feature_head2 = DPTFeature(dims, ld, fd), DPTFeature(dims, ld, fd)
            self.dpt_regressor_head1 = DPTRegressor(fd, out_dim)
            self.dpt_regressor_head2 = DPTRegressor(fd, out_dim)

    def set_lowp(self, mode) -> "ReferenceDUSt3R":
        "Round every trunk linear's input and weight to ``mode`` ('fp8', or None for fp32 products)."
        for part in (self.encoder, self.info_sharing):
            for m in part.modules():
                if isinstance(m, Linear):
                    m.lowp = mode
        return self

    def encode(self, img: torch.Tensor):
        "(B, 3, H, W) -> encoder tokens (B, N, C) after the final norm, and their (B, N, 2) positions."
        x = self.encoder.patch_embed.proj(img)
        B, _, hp, wp = x.shape
        x = x.flatten(2).transpose(1, 2)
        pos = grid_positions(B, hp, wp, img.device)
        for blk in self.encoder.enc_blocks:
            x = blk(x, pos)
        return self.encoder.enc_norm(x), pos, (hp, wp)

    def decode(self, f1, f2, pos):
        "Both views' decoder tokens at each depth in ``dpt_decoder_hooks`` (unnormalised) and the normalised output."
        info = self.info_sharing
        x = [info.proj_embed(f1), info.proj_embed(f2)]
        hooks = set(self.arch.get("dpt_decoder_hooks", ()))
        taken = []
        for i in range(self.arch["dec_depth"]):
            x = [info.multi_view_branches[v][i](x[v], x[1 - v], pos, pos) for v in range(2)]
            if i in hooks:
                taken.append(x)
        return taken, [info.norm(t) for t in x]

    def forward(self, frames1_u8: torch.Tensor, frames2_u8: torch.Tensor):
        """uint8 (B, H, W, 3) frames of both views -> (pts3d1, conf1, pts3d2, conf2), BHWC fp32 (conf with one
        channel), as the served pair returns them."""
        img1, img2 = normalize_frames(frames1_u8), normalize_frames(frames2_u8)
        H, W = img1.shape[-2:]
        B = img1.shape[0]
        enc, pos, (hp, wp) = self.encode(torch.cat([img1, img2]))
        f1, f2 = enc[:B], enc[B:]
        taken, final = self.decode(f1, f2, pos[:B])
        grid = lambda t: t.transpose(1, 2).reshape(B, t.shape[-1], hp, wp)  # noqa: E731
        outs = []
        for v, feat in enumerate((f1, f2)):
            if self.arch["head"] == "linear":
                raw = getattr(self, f"head{v + 1}")(grid(final[v]))
            else:
                hooks = [grid(feat)] + [grid(t[v]) for t in taken] + [grid(final[v])]
                up = getattr(self, f"dpt_feature_head{v + 1}")(hooks)
                raw = getattr(self, f"dpt_regressor_head{v + 1}")(up, (H, W))
            outs.extend(pointmap_and_confidence(raw))
        return tuple(outs)


def pointmap_and_confidence(raw: torch.Tensor):
    "(B, 4, H, W) head output -> pts3d (B, H, W, 3) = xyz / |xyz| * expm1(|xyz|), conf (B, H, W, 1) = 1 + exp(c)."
    xyz, c = raw[:, :3], raw[:, 3:4]
    d = torch.linalg.vector_norm(xyz, dim=1, keepdim=True)
    pts = xyz / d.clamp(min=1e-8) * torch.expm1(d)
    return pts.permute(0, 2, 3, 1), (1.0 + torch.exp(c)).permute(0, 2, 3, 1)

