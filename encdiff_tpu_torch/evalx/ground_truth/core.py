"""The ground-truth data protocol and its discrete state space.

A copy of ``encdiff_tpu/evalx/ground_truth/core.py:19-153``: a dataset is a
two-step generative model (sample discrete factors, then observations
given the factors). Built over ``np.arange(N)``, the observations are
integer indices into a representation array, so the whole metric suite
runs off an (N, latent_unit) array with no image IO (the index-lookup
trick).
"""

from __future__ import annotations

import numpy as np


class GroundTruthData:
    """Two-step generative model protocol."""

    @property
    def num_factors(self) -> int:
        raise NotImplementedError()

    @property
    def factors_num_values(self):
        raise NotImplementedError()

    @property
    def observation_shape(self):
        raise NotImplementedError()

    def sample_factors(self, num, random_state):
        raise NotImplementedError()

    def sample_observations_from_factors(self, factors, random_state):
        raise NotImplementedError()

    def sample(self, num, random_state):
        factors = self.sample_factors(num, random_state)
        return factors, self.sample_observations_from_factors(factors,
                                                              random_state)

    def sample_observations(self, num, random_state):
        return self.sample(num, random_state)[1]


class SplitDiscreteStateSpace:
    """Factors split into latent (evaluated) and observation-only (nuisance)
    indices."""

    def __init__(self, factor_sizes, latent_factor_indices):
        self.factor_sizes = list(factor_sizes)
        self.num_factors = len(self.factor_sizes)
        self.latent_factor_indices = list(latent_factor_indices)
        self.observation_factor_indices = [
            i for i in range(self.num_factors)
            if i not in self.latent_factor_indices]

    @property
    def num_latent_factors(self) -> int:
        return len(self.latent_factor_indices)

    def _sample_factor(self, i, num, random_state):
        return random_state.randint(self.factor_sizes[i], size=num)

    def sample_latent_factors(self, num, random_state):
        out = np.zeros((num, self.num_latent_factors), dtype=np.int64)
        for pos, i in enumerate(self.latent_factor_indices):
            out[:, pos] = self._sample_factor(i, num, random_state)
        return out

    def sample_all_factors(self, latent_factors, random_state):
        num = latent_factors.shape[0]
        out = np.zeros((num, self.num_factors), dtype=np.int64)
        out[:, self.latent_factor_indices] = latent_factors
        for i in self.observation_factor_indices:
            out[:, i] = self._sample_factor(i, num, random_state)
        return out


def factor_bases(factor_sizes) -> np.ndarray:
    """Row-major mixed-radix bases: index = factors . bases."""
    sizes = np.asarray(factor_sizes, dtype=np.float64)
    return np.prod(sizes) / np.cumprod(sizes)


class StateSpaceAtomIndex:
    """Maps factor configurations to row positions of a feature table that
    enumerates the state space in arbitrary order."""

    def __init__(self, factor_sizes, features):
        self.factor_sizes = list(factor_sizes)
        num_atoms = int(np.prod(self.factor_sizes))
        self.factor_bases = factor_bases(self.factor_sizes)
        ssi = self._to_state_space_index(features)
        if np.unique(ssi).size != num_atoms:
            raise ValueError("Features matrix does not cover the state space.")
        lookup = np.zeros(num_atoms, dtype=np.int64)
        lookup[ssi] = np.arange(num_atoms)
        self.state_space_to_save_space_index = lookup

    def features_to_index(self, features):
        return self.state_space_to_save_space_index[
            self._to_state_space_index(features)]

    def _to_state_space_index(self, features):
        features = np.asarray(features)
        if (np.any(features > np.expand_dims(self.factor_sizes, 0))
                or np.any(features < 0)):
            raise ValueError("Feature indices out of range.")
        return np.array(np.dot(features, self.factor_bases), dtype=np.int64)


class IndexBackedDataset(GroundTruthData):
    """Dataset whose observations are rows of a preloaded array (or raw
    integer indices, for the representation-lookup trick)."""

    def __init__(self, images, factor_sizes, latent_factor_indices=None,
                 observation_shape=(64, 64, 3)):
        self.images = images
        self.factor_sizes = list(factor_sizes)
        if latent_factor_indices is None:
            latent_factor_indices = list(range(len(self.factor_sizes)))
        self.latent_factor_indices = list(latent_factor_indices)
        self.num_total_factors = len(self.factor_sizes)
        self.state_space = SplitDiscreteStateSpace(self.factor_sizes,
                                                   self.latent_factor_indices)
        self.factor_bases = factor_bases(self.factor_sizes)
        self._observation_shape = tuple(observation_shape)

    @property
    def num_factors(self):
        return self.state_space.num_latent_factors

    @property
    def factors_num_values(self):
        return [self.factor_sizes[i] for i in self.latent_factor_indices]

    @property
    def observation_shape(self):
        return self._observation_shape

    def factors_to_index(self, all_factors):
        return np.array(np.dot(all_factors, self.factor_bases), dtype=np.int64)

    def sample_factors(self, num, random_state):
        return self.state_space.sample_latent_factors(num, random_state)

    def sample_observations_from_factors(self, factors, random_state):
        all_factors = self.state_space.sample_all_factors(factors, random_state)
        return self.images[self.factors_to_index(all_factors)]
