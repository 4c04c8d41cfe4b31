"""GAE, VGAE, ARGA and ARGVA with the inner-product decoder.

Counterpart of ``pytorch_geometric_tpu/nn/models/autoencoder.py``
(reference ``torch_geometric/nn/models/autoencoder.py``). The encoder is
any module; decoding and the losses are functions of the embeddings. The
reparametrisation's noise, and the discriminator's real samples, come from
a ``torch.Generator`` (drawn on the generator's device) or are handed in
as ``noise``.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..conv.graph_conv import _coo
from .misc_models import _draw

EPS = 1e-15
MAX_LOGSTD = 10.0


def _normal_like(t: torch.Tensor, generator: Optional[torch.Generator],
                 noise: Optional[torch.Tensor]) -> torch.Tensor:
    if noise is not None:
        return noise.to(t.device, t.dtype)
    return _draw(t.shape, generator, t, normal=True)


class InnerProductDecoder(nn.Module):
    """``sigmoid(z_i . z_j)`` per edge (reference
    ``autoencoder.py:InnerProductDecoder``); ``decode_all`` gives the
    dense ``[N, N]`` matrix."""

    def forward(self, z, edge_index, sigmoid: bool = True) -> torch.Tensor:
        return self.decode(z, edge_index, sigmoid)

    @staticmethod
    def decode(z: torch.Tensor, edge_index,
               sigmoid: bool = True) -> torch.Tensor:
        coo = _coo(edge_index).long()
        value = (z[coo[0]] * z[coo[1]]).sum(-1)
        return torch.sigmoid(value) if sigmoid else value

    @staticmethod
    def decode_all(z: torch.Tensor, sigmoid: bool = True) -> torch.Tensor:
        adj = z @ z.T
        return torch.sigmoid(adj) if sigmoid else adj


class GAE(nn.Module):
    """Graph autoencoder (reference ``autoencoder.py:GAE``): ``forward`` is
    the encoder."""

    def __init__(self, encoder: nn.Module):
        super().__init__()
        self.encoder = encoder

    def forward(self, *args, **kwargs):
        return self.encode(*args, **kwargs)

    def encode(self, *args, **kwargs):
        return self.encoder(*args, **kwargs)

    decode = staticmethod(InnerProductDecoder.decode)

    @staticmethod
    def recon_loss(z: torch.Tensor, pos_edge_index,
                   neg_edge_index) -> torch.Tensor:
        """Binary cross-entropy over the positive and the given negative
        edges, from the logits through ``logsigmoid``."""
        pos = InnerProductDecoder.decode(z, pos_edge_index, sigmoid=False)
        neg = InnerProductDecoder.decode(z, neg_edge_index, sigmoid=False)
        return -F.logsigmoid(pos).mean() - F.logsigmoid(-neg).mean()


class VGAE(nn.Module):
    """Variational GAE (reference ``autoencoder.py:VGAE``): the encoder
    returns ``(mu, logstd)``; ``forward`` returns ``(z, mu, logstd)``, the
    log-std capped at ``max_logstd`` and ``z = mu + noise *
    exp(logstd)``."""

    def __init__(self, encoder: nn.Module, max_logstd: float = MAX_LOGSTD):
        super().__init__()
        self.encoder = encoder
        self.max_logstd = max_logstd

    def forward(self, *args, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, **kwargs):
        mu, logstd = self.encoder(*args, **kwargs)
        logstd = logstd.clamp(max=self.max_logstd)
        return self.reparametrize(mu, logstd, generator, noise), mu, logstd

    @staticmethod
    def reparametrize(mu, logstd, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return mu + _normal_like(mu, generator, noise) * torch.exp(logstd)

    @staticmethod
    def kl_loss(mu: torch.Tensor, logstd: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.mean(torch.sum(
            1 + 2 * logstd - mu ** 2 - torch.exp(logstd) ** 2, dim=1))

    decode = staticmethod(InnerProductDecoder.decode)
    recon_loss = staticmethod(GAE.recon_loss)


class ARGA(nn.Module):
    """Adversarially regularised GAE (reference ``autoencoder.py:ARGA``):
    ``forward`` is the encoder; ``reg_loss`` pushes the discriminator to
    call ``z`` real, ``discriminator_loss`` trains it on standard normal
    samples (real) against a detached ``z`` (fake)."""

    def __init__(self, encoder: nn.Module, discriminator: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.discriminator = discriminator

    def forward(self, *args, **kwargs):
        return self.encoder(*args, **kwargs)

    def discriminate(self, z):
        return self.discriminator(z)

    recon_loss = staticmethod(GAE.recon_loss)

    def reg_loss(self, z) -> torch.Tensor:
        real = torch.sigmoid(self.discriminate(z))
        return -torch.log(real + EPS).mean()

    def discriminator_loss(self, z,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        real = torch.sigmoid(self.discriminate(
            _normal_like(z, generator, noise)))
        fake = torch.sigmoid(self.discriminate(z.detach()))
        return (-torch.log(real + EPS).mean()
                - torch.log(1 - fake + EPS).mean())


class ARGVA(ARGA):
    """Adversarially regularised VGAE (reference ``autoencoder.py:ARGVA``):
    ``forward`` returns ``(z, mu, logstd)`` as :class:`VGAE`'s, the log-std
    capped at 10."""

    def forward(self, *args, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                **kwargs) -> Tuple[torch.Tensor, ...]:
        mu, logstd = self.encoder(*args, **kwargs)
        logstd = logstd.clamp(max=MAX_LOGSTD)
        return VGAE.reparametrize(mu, logstd, generator, noise), mu, logstd

    kl_loss = staticmethod(VGAE.kl_loss)
