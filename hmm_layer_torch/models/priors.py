"""MAP priors of the profile-HMM parameters (port of
``hmm_layer_tpu/models/priors.py``).

* :class:`ProfileHMMTransitionPrior` — Dirichlet priors on the
  match/insert/delete transition triples plus closed-form flank
  (``alpha_flank``), single-hit (``alpha_single``) and global entry/exit
  (``alpha_global``) terms.
* :class:`AminoAcidPrior` — Dirichlet mixture over match-state emission
  distributions.

The default mixtures are the trained ones shipped in
``hmm_layer_torch/trained_priors/`` (byte-identical copies of the JAX
package's artifacts, read with NumPy only); a missing artifact falls back
to a documented single-component prior. The priors hold their parameters
as NumPy arrays and score torch tensors on the tensors' device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .dirichlet import DirichletMixture, dirichlet_log_pdf

__all__ = [
    "ProfileHMMTransitionPrior",
    "AminoAcidPrior",
    "FixedDirichlet",
    "load_trained_prior",
]

_TRAINED_PRIOR_DIR = os.path.join(os.path.dirname(__file__), "..", "trained_priors")


def _np_softplus(x):
    x = np.asarray(x, np.float64)
    return np.where(x > 30.0, x, np.log1p(np.exp(np.minimum(x, 30.0))))


def _np_softmax(x):
    x = np.asarray(x, np.float64)
    e = np.exp(x - x.max())
    return e / e.sum()


def load_trained_prior(name, fallback_alpha=None):
    """A :class:`FixedDirichlet` from a trained mixture artifact.

    Artifacts live in ``hmm_layer_torch/trained_priors/<name>.npz``
    (mixture parameters as written by
    :func:`~hmm_layer_torch.models.dirichlet.save_mixture_model`). Loads
    with NumPy only. Falls back to ``FixedDirichlet(fallback_alpha)`` when
    the artifact is absent.
    """
    path = os.path.join(_TRAINED_PRIOR_DIR, f"{name}.npz")
    if os.path.exists(path):
        with np.load(path) as data:
            alpha = _np_softplus(data["alpha_kernel"])
            mix = _np_softmax(data["mix_kernel"])
        return FixedDirichlet(alpha, mix)
    if fallback_alpha is None:
        raise FileNotFoundError(
            f"trained prior artifact {path} missing and no fallback given; "
            "train a mixture and save it with save_mixture_model"
        )
    return FixedDirichlet(fallback_alpha)


class FixedDirichlet:
    """A fixed (non-trainable) Dirichlet mixture used as a prior component."""

    def __init__(self, alpha, mix=None):
        self.alpha = np.asarray(alpha, np.float32)
        if self.alpha.ndim == 1:
            self.alpha = self.alpha[None]
        self.mix = (
            np.full((self.alpha.shape[0],), 1.0 / self.alpha.shape[0], np.float32)
            if mix is None
            else np.asarray(mix, np.float32)
        )
        self._tensors = {}  # device -> (alpha, mix): one copy per device

    @classmethod
    def from_params(cls, model: DirichletMixture):
        """The fixed mixture of a (trained) :class:`DirichletMixture`."""
        with torch.no_grad():
            return cls(model.make_alpha().cpu().numpy(), model.make_mix().cpu().numpy())

    def log_pdf(self, p):
        if p.device not in self._tensors:
            with torch.inference_mode(False):  # usable by autograd later
                self._tensors[p.device] = (
                    torch.as_tensor(self.alpha, device=p.device),
                    torch.as_tensor(self.mix, device=p.device),
                )
        return dirichlet_log_pdf(p, *self._tensors[p.device])

    def get_config(self):
        return {"alpha": self.alpha.tolist(), "mix": self.mix.tolist()}

    @classmethod
    def from_config(cls, config):
        return cls(config["alpha"], config.get("mix"))


class ProfileHMMTransitionPrior:
    """Default Dirichlet-mixture prior on profile-HMM transitions.

    Args:
        match_dirichlet / insert_dirichlet / delete_dirichlet: mixtures over
            the 3-dim (MM, MI, MD) / 2-dim (IM, II) / 2-dim (DM, DD)
            simplices. Defaults are the trained mixtures of
            :func:`load_trained_prior`.
        alpha_flank: biases flank-loop probabilities high.
        alpha_single: biases single main-model hits (no loops).
        alpha_global: biases entry at the first and exit at the last match.
    """

    def __init__(
        self,
        match_dirichlet=None,
        insert_dirichlet=None,
        delete_dirichlet=None,
        alpha_flank=7000.0,
        alpha_single=1e9,
        alpha_global=1e4,
        alpha_flank_compl=1.0,
        alpha_single_compl=1.0,
        alpha_global_compl=1.0,
        epsilon=1e-16,
    ):
        # Defaults are the trained mixtures shipped with the package, with
        # mild single-component values as fallback if artifacts are absent.
        self.match_dirichlet = match_dirichlet or load_trained_prior(
            "match_prior_1", [10.0, 2.0, 2.0]
        )
        self.insert_dirichlet = insert_dirichlet or load_trained_prior(
            "insert_prior_1", [2.0, 2.0]
        )
        self.delete_dirichlet = delete_dirichlet or load_trained_prior(
            "delete_prior_1", [2.0, 2.0]
        )
        self.alpha_flank = alpha_flank
        self.alpha_single = alpha_single
        self.alpha_global = alpha_global
        self.alpha_flank_compl = alpha_flank_compl
        self.alpha_single_compl = alpha_single_compl
        self.alpha_global_compl = alpha_global_compl
        self.epsilon = epsilon

    def get_config(self):
        return {
            "match_dirichlet": self.match_dirichlet.get_config(),
            "insert_dirichlet": self.insert_dirichlet.get_config(),
            "delete_dirichlet": self.delete_dirichlet.get_config(),
            "alpha_flank": self.alpha_flank,
            "alpha_single": self.alpha_single,
            "alpha_global": self.alpha_global,
            "alpha_flank_compl": self.alpha_flank_compl,
            "alpha_single_compl": self.alpha_single_compl,
            "alpha_global_compl": self.alpha_global_compl,
            "epsilon": self.epsilon,
        }

    @classmethod
    def from_config(cls, config):
        config = dict(config)
        for name in ("match_dirichlet", "insert_dirichlet", "delete_dirichlet"):
            if config.get(name) is not None:
                config[name] = FixedDirichlet.from_config(config[name])
        return cls(**config)

    def __call__(self, probs_list, flank_init_prob):
        """Per-prior values, each (num_models,), from the per-model dicts
        of explicit edge probabilities
        (:meth:`~hmm_layer_torch.models.ProfileTransitions.make_probs`) and
        the flank-init probabilities (m,)."""
        eps = self.epsilon
        match_d, insert_d, delete_d = [], [], []
        flank_p, hit_p, global_p = [], [], []
        for i, probs in enumerate(probs_list):
            log_probs = {k: torch.log(torch.clamp_min(v, eps)) for k, v in probs.items()}
            p_match = (
                torch.stack(
                    [
                        probs["match_to_match"],
                        probs["match_to_insert"],
                        probs["match_to_delete"][1:],
                    ],
                    dim=-1,
                )
                + eps
            )
            p_match = p_match / p_match.sum(-1, keepdim=True)
            match_d.append(self.match_dirichlet.log_pdf(p_match).sum())
            p_insert = torch.stack([probs["insert_to_match"], probs["insert_to_insert"]], dim=-1)
            insert_d.append(self.insert_dirichlet.log_pdf(p_insert).sum())
            p_delete = torch.stack([probs["delete_to_match"][:-1], probs["delete_to_delete"]], dim=-1)
            delete_d.append(self.delete_dirichlet.log_pdf(p_delete).sum())

            flank = (self.alpha_flank - 1) * log_probs["unannotated_segment_loop"]
            flank = flank + (self.alpha_flank - 1) * log_probs["right_flank_loop"]
            flank = flank + (self.alpha_flank - 1) * log_probs["left_flank_loop"]
            flank = flank + (self.alpha_flank - 1) * log_probs["end_to_right_flank"]
            flank = flank + (self.alpha_flank - 1) * torch.log(flank_init_prob[i])
            flank = flank + (self.alpha_flank_compl - 1) * log_probs[
                "unannotated_segment_exit"
            ]
            flank = flank + (self.alpha_flank_compl - 1) * log_probs["right_flank_exit"]
            flank = flank + (self.alpha_flank_compl - 1) * log_probs["left_flank_exit"]
            flank = flank + (self.alpha_flank_compl - 1) * torch.log(
                probs["end_to_unannotated_segment"] + probs["end_to_terminal"]
            )
            flank = flank + (self.alpha_flank_compl - 1) * torch.log(
                torch.clamp_min(1 - flank_init_prob[i], eps)
            )
            flank_p.append(flank.squeeze())

            hit = (self.alpha_single - 1) * torch.log(
                probs["end_to_right_flank"] + probs["end_to_terminal"]
            )
            hit = hit + (self.alpha_single_compl - 1) * torch.log(
                probs["end_to_unannotated_segment"]
            )
            hit_p.append(hit.squeeze())

            div = torch.clamp_min(1 - probs["match_to_delete"][0], eps)
            btm = probs["begin_to_match"] / div
            enex = btm[:, None] * probs["match_to_end"][None, :]
            enex = torch.tril(enex)
            log_enex = torch.log(torch.clamp_min(1 - enex, eps))
            log_enex_compl = torch.log(torch.clamp_min(enex, eps))
            glob = (self.alpha_global - 1) * (log_enex.sum() - log_enex[0, -1])
            glob = glob + (self.alpha_global_compl - 1) * (
                log_enex_compl.sum() - log_enex_compl[0, -1]
            )
            global_p.append(glob)
        return {
            "match_prior": torch.stack(match_d),
            "insert_prior": torch.stack(insert_d),
            "delete_prior": torch.stack(delete_d),
            "flank_prior": torch.stack(flank_p),
            "hit_prior": torch.stack(hit_p),
            "global_prior": torch.stack(global_p),
        }


class AminoAcidPrior:
    """Dirichlet prior over match-state amino-acid distributions.

    Scores each match state's emission distribution (first 20 channels,
    renormalised) under a Dirichlet mixture: by default the trained
    9-component ``amino_prior_9``.
    """

    def __init__(self, dirichlet=None, epsilon=1e-16):
        self.dirichlet = dirichlet or load_trained_prior(
            "amino_prior_9", np.full((20,), 1.1)
        )
        self.epsilon = epsilon

    def get_config(self):
        return {
            "dirichlet": self.dirichlet.get_config(),
            "epsilon": self.epsilon,
        }

    @classmethod
    def from_config(cls, config):
        config = dict(config)
        if config.get("dirichlet") is not None:
            config["dirichlet"] = FixedDirichlet.from_config(config["dirichlet"])
        return cls(**config)

    def __call__(self, B, lengths):
        """Args: B (num_models, q_max, s); returns (num_models,).

        Match states occupy rows 1..L (state order LEFT_FLANK, MATCH x L,
        ...)."""
        vals = []
        for i, length in enumerate(lengths):
            match_rows = B[i, 1 : length + 1, :20]
            match_rows = match_rows / torch.clamp_min(
                match_rows.sum(-1, keepdim=True), self.epsilon
            )
            vals.append(self.dirichlet.log_pdf(match_rows).sum())
        return torch.stack(vals)
