"""Variational U-Net for vehicle novel-view synthesis, NHWC.

Counterpart of the JAX package's models/vunet.py (``Vunet`` with
``encode_appearance`` :487 and ``decode_shape`` :494, built on ``forward_enc_up``
:365, ``forward_enc_down`` :380, ``forward_dec_up`` :403, ``forward_dec_down`` :428)
in the deployment config (subpixel up mode, weight norm). Serving samples with
``cov = 0``: every latent is its mean (the JAX package's choice, PARITY §7), and no
noise is drawn. Training samples with ``cov = 1``: every ``Sampler`` returns
``(mu, mu + noise * cov)``, the noise from a ``NoiseSource``. Dropout never runs
(the JAX trainer applies the network deterministically). Module names are the
reference's (vunet/models.py:17-485), so ``vunet.pth`` loads unchanged.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.models.layers import (
    WNConv2d,
    depth_to_space,
    space_to_depth,
)


class NoiseSource:
    """Standard-normal noise for the samplers, one draw per ``Sampler`` call in call
    order (appearance decoder: 2 draws; each autoregressive block: 4). ``source`` is
    a ``torch.Generator`` (the noise is drawn on the generator's device and moved to
    the tensor's if that is another one: a CPU generator gives a CPU and a CUDA run
    the same noise), or an iterable of ready noise tensors (what a comparison with
    another implementation hands in)."""

    def __init__(self, source):
        self._gen = source if isinstance(source, torch.Generator) else None
        self._given = None if self._gen is not None else iter(source)

    def draw(self, like: torch.Tensor) -> torch.Tensor:
        if self._gen is not None:
            return torch.randn(like.shape, dtype=like.dtype, device=self._gen.device,
                               generator=self._gen).to(like.device)
        noise = next(self._given)
        if noise.shape != like.shape:
            raise ValueError(f"noise of shape {tuple(noise.shape)} handed to a sampler "
                             f"of shape {tuple(like.shape)}")
        return noise.to(like)


class MyConv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        self.conv = WNConv2d(cin, cout, k, stride, padding)

    def forward(self, x, skip_in=None):
        if skip_in is not None:
            x = torch.cat([x, skip_in], dim=-1)
        return self.conv(x)


class NiN(nn.Module):
    """elu -> 1x1 conv; the conv is Sequential index 1."""

    def __init__(self, cin, cout):
        super().__init__()
        self.layers = nn.Sequential(nn.Identity(), MyConv(cin, cout, 1))

    def forward(self, x):
        return self.layers[1](F.elu(x))


class Residual(nn.Module):
    """concat-skip -> elu -> 3x3 conv, + residual; the conv is Sequential index 2."""

    def __init__(self, cin, cout):
        super().__init__()
        self.layers = nn.Sequential(nn.Identity(), nn.Identity(), MyConv(cin, cout, 3, 1, 1))

    def forward(self, x, skip_in=None):
        residual = x
        if skip_in is not None:
            x = torch.cat([residual, skip_in], dim=-1)
        return self.layers[2](F.elu(x)) + residual


class DownSample(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.down = MyConv(cin, cout, 3, 2, 1)

    def forward(self, x):
        return self.down(x)


class UpSample(nn.Module):
    """subpixel: 3x3 conv to 4x channels, then TF-ordered depth_to_space."""

    def __init__(self, cin, cout):
        super().__init__()
        self.depth4x = MyConv(cin, 4 * cout, 3, 1, 1)

    def forward(self, x, skip_in=None):
        if skip_in is not None:
            x = torch.cat([x, skip_in], dim=-1)
        return depth_to_space(self.depth4x(x), 2)


class Sampler(nn.Module):
    """mu = conv(x); sample = mu + N(0, 1) * cov (vunet/layers.py:158-170). Returns
    (mu, sample); with cov = 0 the sample is mu and nothing is drawn."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = MyConv(cin, cout, 3, 1, 1)

    def forward(self, x, cov: float = 0.0, noise: NoiseSource = None):
        mu = self.conv(x)
        if cov == 0.0:
            return mu, mu
        return mu, mu + noise.draw(mu) * cov


class InitBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.nin = NiN(cin, cout)
        self.residual_0 = Residual(cout, cout)
        self.residual_1 = Residual(cout, cout)

    def forward(self, x):
        x = self.nin(x)
        x = self.residual_0(x)
        s0 = x
        x = self.residual_1(x)
        return x, [s0, x]


class DownBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.down = DownSample(cin, cout)
        self.residual_0 = Residual(cout, cout)
        self.residual_1 = Residual(cout, cout)

    def forward(self, x):
        x = self.down(x)
        x = self.residual_0(x)
        s0 = x
        x = self.residual_1(x)
        return x, [s0, x]


class UpBlock(nn.Module):
    def __init__(self, cin, cmid, cout):
        super().__init__()
        self.residual_0 = Residual(cin, cmid)
        self.residual_1 = Residual(cin, cmid)
        self.up = UpSample(cmid, cout)

    def forward(self, x, skip_a, skip_b):
        return self.up(self.residual_1(self.residual_0(x, skip_a), skip_b))


class EndBlock(nn.Module):
    def __init__(self, cin, cmid, cout):
        super().__init__()
        self.residual_0 = Residual(cin, cmid)
        self.residual_1 = Residual(cin, cmid)
        self.conv = MyConv(cmid, cout, 3, 1, 1)

    def forward(self, x, skip_a, skip_b):
        return self.conv(self.residual_1(self.residual_0(x, skip_a), skip_b))


class AutoRegressiveBlock(nn.Module):
    """4-quadrant autoregressive latent block (vunet/models.py:17-89): each
    quadrant's latent is sampled and chained through residuals; with the appearance
    latents given, the chained input is the NiN'd appearance quadrant instead of the
    sampled latent. Returns (x, mu, z)."""

    def __init__(self):
        super().__init__()
        self.residual_init = Residual(256, 128)
        self.residual_s2d = Residual(128, 128)
        for i in range(4):
            self.add_module(f"sampler_{i}", Sampler(512, 128))
        for i in range(3):
            self.add_module(f"residual_{i}", Residual(1024, 512))
            self.add_module(f"nin_{i}", NiN(128, 512))

    def forward(self, x, skip_a, enc_down_mu=None, cov: float = 0.0, noise=None):
        x = self.residual_init(x, skip_a)
        x_ = space_to_depth(self.residual_s2d(x), 2)
        if enc_down_mu is not None:
            gs = torch.chunk(space_to_depth(enc_down_mu, 2), 4, dim=-1)
            g = [getattr(self, f"nin_{i}")(gs[i]) for i in range(3)]
        mus, zs = [], []
        for i in range(4):
            mu_i, z_i = getattr(self, f"sampler_{i}")(x_, cov, noise)
            mus.append(mu_i)
            zs.append(z_i)
            if i < 3:
                skip = g[i] if enc_down_mu is not None else getattr(self, f"nin_{i}")(z_i)
                x_ = getattr(self, f"residual_{i}")(x_, skip)
        mu = depth_to_space(torch.cat(mus, dim=-1), 2)
        z = mu if cov == 0.0 else depth_to_space(torch.cat(zs, dim=-1), 2)
        return x, mu, z


class Vunet(nn.Module):
    def __init__(self, vunet_256: bool = True):
        super().__init__()
        self.vunet_256 = vunet_256
        self.app_encoder_1 = InitBlock(6, 128)
        self.app_encoder_1_a = DownBlock(128, 128)
        self.app_encoder_1_b = DownBlock(128, 128)
        if vunet_256:
            self.app_encoder_1_c = DownBlock(128, 128)
        self.app_encoder_2 = DownBlock(128, 128)
        self.app_encoder_3 = DownBlock(128, 128)
        self.app_encoder_4 = DownBlock(128, 128)
        self.app_skip_3_c = NiN(128, 128)
        self.app_skip_4_c = NiN(128, 128)
        self.app_bottleneck = MyConv(128, 128, 1)
        self.app_decoder_1_a = Residual(256, 128)
        self.app_decoder_1_b = Sampler(128, 128)
        self.app_decoder_1_c = MyConv(256, 128, 1)
        self.app_decoder_1_d = Residual(256, 128)
        self.app_decoder_1_e = UpSample(128, 128)
        self.app_decoder_2_a = Residual(128, 128)
        self.app_decoder_2_b = Sampler(128, 128)
        self.shape_encoder_1 = InitBlock(3, 32)
        if vunet_256:
            self.shape_encoder_1_a = DownBlock(32, 32)
            self.shape_skip_1_a_b = NiN(32, 32)
            self.shape_skip_1_a_c = NiN(32, 32)
        self.shape_encoder_2 = DownBlock(32, 64)
        self.shape_encoder_3 = DownBlock(64, 128)
        self.shape_encoder_4 = DownBlock(128, 128)
        self.shape_encoder_5 = DownBlock(128, 128)
        self.shape_encoder_6 = DownBlock(128, 128)
        self.shape_skip_1_b = NiN(32, 32)
        self.shape_skip_1_c = NiN(32, 32)
        self.shape_skip_2_b = NiN(64, 64)
        self.shape_skip_2_c = NiN(64, 64)
        for i in (3, 4, 5, 6):
            self.add_module(f"shape_skip_{i}_b", NiN(128, 128))
            self.add_module(f"shape_skip_{i}_c", NiN(128, 128))
        self.shape_bottleneck = MyConv(128, 128, 1)
        self.shape_decoder_1 = AutoRegressiveBlock()
        self.shape_decoder_1_n = NiN(256, 128)
        self.shape_decoder_1_o = Residual(256, 128)
        self.shape_decoder_1_p = UpSample(128, 128)
        self.shape_decoder_2 = AutoRegressiveBlock()
        self.shape_decoder_2_n = NiN(256, 128)
        self.shape_decoder_2_o = Residual(256, 128)
        self.shape_decoder_2_p = UpSample(128, 128)
        self.shape_decoder_3 = UpBlock(256, 128, 128)
        self.shape_decoder_4 = UpBlock(256, 128, 64)
        self.shape_decoder_5 = UpBlock(128, 64, 32)
        if vunet_256:
            self.shape_decoder_5_a = UpBlock(64, 32, 32)
        self.shape_decoder_6 = EndBlock(64, 32, 3)

    # -- appearance branch (vunet/models.py:333-353, 390-408) ---------------------

    def forward_enc_up(self, x):
        skips = []
        x, _ = self.app_encoder_1(x)
        x, _ = self.app_encoder_1_a(x)
        x, _ = self.app_encoder_1_b(x)
        if self.vunet_256:
            x, _ = self.app_encoder_1_c(x)
        x, _ = self.app_encoder_2(x)
        x, _ = self.app_encoder_3(x)
        skips.append(self.app_skip_3_c(x))
        x, sl = self.app_encoder_4(x)
        outputs = [sl[-2], x]
        skips.append(self.app_skip_4_c(x))
        return outputs, skips

    def forward_enc_down(self, enc_up_outputs, skips, cov: float = 0.0, noise=None):
        """([mu_0, mu_1], [z_0, z_1]) of the appearance decoder."""
        x = self.app_bottleneck(enc_up_outputs[-1])
        x = self.app_decoder_1_a(x, skips[-1])
        mu_0, z_0 = self.app_decoder_1_b(x, cov, noise)
        x_ = self.app_decoder_1_c(torch.cat([enc_up_outputs[-2], z_0], dim=-1))
        x = self.app_decoder_1_d(x, x_)
        x = self.app_decoder_1_e(x)
        x = self.app_decoder_2_a(x, None)
        mu_1, z_1 = self.app_decoder_2_b(x, cov, noise)
        return [mu_0, mu_1], [z_0, z_1]

    # -- shape branch (vunet/models.py:355-388, 410-459) --------------------------

    def forward_dec_up(self, y_tilde):
        skips = []
        x, sl = self.shape_encoder_1(y_tilde)
        skips += [self.shape_skip_1_b(sl[-2]), self.shape_skip_1_c(sl[-1])]
        if self.vunet_256:
            x, sl = self.shape_encoder_1_a(x)
            skips += [self.shape_skip_1_a_b(sl[-2]), self.shape_skip_1_a_c(sl[-1])]
        for i in (2, 3, 4, 5, 6):
            x, sl = getattr(self, f"shape_encoder_{i}")(x)
            skips += [
                getattr(self, f"shape_skip_{i}_b")(sl[-2]),
                getattr(self, f"shape_skip_{i}_c")(sl[-1]),
            ]
        return [x], skips

    def forward_dec_down(self, dec_up_outputs, skips, enc_down_mu=(), cov: float = 0.0,
                         noise=None):
        """(x_tilde, [mu_0, mu_1], [z_0, z_1]) of the shape decoder; ``enc_down_mu``
        are the appearance latents that steer the two autoregressive blocks (empty:
        the blocks chain their own samples)."""
        skips = list(skips)
        x = self.shape_bottleneck(dec_up_outputs[-1])
        skip_a, skip_b = skips.pop(), skips.pop()
        mu_a = None if len(enc_down_mu) == 0 else enc_down_mu[0]
        x, mu_0, z_0 = self.shape_decoder_1(x, skip_a, mu_a, cov, noise)
        x = self.shape_decoder_1_n(torch.cat([x, z_0], dim=-1))
        x = self.shape_decoder_1_o(x, skip_b)
        x = self.shape_decoder_1_p(x)
        skip_a, skip_b = skips.pop(), skips.pop()
        mu_a = None if len(enc_down_mu) == 0 else enc_down_mu[1]
        x, mu_1, z_1 = self.shape_decoder_2(x, skip_a, mu_a, cov, noise)
        x = self.shape_decoder_2_n(torch.cat([x, z_1], dim=-1))
        x = self.shape_decoder_2_o(x, skip_b)
        x = self.shape_decoder_2_p(x)
        x = self.shape_decoder_3(x, skips.pop(), skips.pop())
        x = self.shape_decoder_4(x, skips.pop(), skips.pop())
        x = self.shape_decoder_5(x, skips.pop(), skips.pop())
        if self.vunet_256:
            x = self.shape_decoder_5_a(x, skips.pop(), skips.pop())
        x = self.shape_decoder_6(x, skips.pop(), skips.pop())
        assert not skips
        return x, [mu_0, mu_1], [z_0, z_1]

    def forward(self, y_tilde, x_app, cov: float = 1.0, noise=None):
        """The training forward (vunet/models.py:461-481, ``mean_appearance``):
        (x_tilde, mu_app, mu_shape); the shape decoder is steered by the SAMPLED
        appearance latents. ``noise``: what ``NoiseSource`` takes (needed for
        cov != 0)."""
        noise = None if noise is None else NoiseSource(noise)
        mu_app, z_app = self.forward_enc_down(*self.forward_enc_up(x_app), cov, noise)
        x_tilde, mu_shape, _ = self.forward_dec_down(*self.forward_dec_up(y_tilde), z_app,
                                                     cov, noise)
        return x_tilde, mu_app, mu_shape

    def encode_appearance(self, x):
        """Appearance means [mu_0, mu_1] of x (B, 256, 256, 6), once per vehicle
        (serving: cov = 0)."""
        return self.forward_enc_down(*self.forward_enc_up(x))[0]

    def decode_shape(self, y_tilde, mu_app):
        """Novel view (B, 256, 256, 3) from a dst sketch y_tilde and the
        appearance means, each with leading B (serving: cov = 0)."""
        return self.forward_dec_down(*self.forward_dec_up(y_tilde), mu_app)[0]
