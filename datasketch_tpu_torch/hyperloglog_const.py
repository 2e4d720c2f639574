"""The HLL++ empirical bias-correction tables under the reference's
``datasketch.hyperloglog_const`` names: ``_thresholds``, ``_raw_estimate``
and ``_bias``, lists indexed by ``p - 4`` for p in 4..18. They are read
from ``models/_hllpp_bias.npz`` (a copy of the JAX package's asset)."""

from datasketch_tpu_torch.models.hyperloglog import _bias_tables

_t, _re, _b = _bias_tables()
_thresholds = [int(x) for x in _t]
_raw_estimate = [_re[p].tolist() for p in range(4, 19)]
_bias = [_b[p].tolist() for p in range(4, 19)]

del _t, _re, _b
