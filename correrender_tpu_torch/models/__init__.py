"""Neural networks: the counterpart of ``correrender_tpu/models``
(reference src/Calculators/VMLP/ and the PyTorch / tiny-cuda-nn /
QuickMLP calculator backends, collapsed onto one model family).

* encodings: Identity / Frequency / multiresolution HashGrid
  (instant-NGP-style, PRIME hashing + DENSE mode, nearest/linear) /
  Dictionary / Composite (reference Encoding.hpp:46-232);
* MLP with activations {none, relu, snake, snake_alt}
  (Network.hpp:49-53), float32 or bfloat16 compute;
* symmetrizers {add, add_diff, mul} (SymmetrizerType.hpp);
* the SRN and MINE network types (CorrelationDefines.hpp:81-99) with
  their trainers.

Plain PyTorch: the JAX package has no Pallas kernel here either (its
products are ``jnp.dot``). Parameters are trees of tensors in the JAX
package's layout (:mod:`~correrender_tpu_torch.models.tree`).
"""

from correrender_tpu_torch.models.encodings import (
    IdentityEncoding,
    FrequencyEncoding,
    HashGridEncoding,
    DictionaryEncoding,
    CompositeEncoding,
)
from correrender_tpu_torch.models.vmlp import MLP, ACTIVATIONS
from correrender_tpu_torch.models.symmetrizer import symmetrize, SYMMETRIZERS
from correrender_tpu_torch.models.mine import (
    CorrelationSRN,
    train_srn,
    MineEstimator,
    train_mine,
)

__all__ = [
    "IdentityEncoding",
    "FrequencyEncoding",
    "HashGridEncoding",
    "DictionaryEncoding",
    "CompositeEncoding",
    "MLP",
    "ACTIVATIONS",
    "symmetrize",
    "SYMMETRIZERS",
    "CorrelationSRN",
    "train_srn",
    "MineEstimator",
    "train_mine",
]
