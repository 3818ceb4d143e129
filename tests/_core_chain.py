"""The core step as the port computed it before its prefix/suffix partitions.

One exact ``subset_ids`` sort chain over the other A - 1 columns for each
attribute a, then Θ(D|C\\{a}) from its contingency: the plain reference the
CPU and card tests hold ``reduction._core_inner_thetas`` to, bit for bit.
"""
import numpy as np

from repro_torch.core import measures
from repro_torch.core.plan import contingency_from_ids, subset_ids


def core_by_subset_chains(gran, delta):
    A = gran.n_attrs
    out = np.zeros((A,), np.float64)
    for a in range(A):
        ids, _ = subset_ids(gran, [j for j in range(A) if j != a], exact=True)
        cont = contingency_from_ids(ids, gran.d, gran.w, gran.valid,
                                    n_bins=gran.capacity, m=gran.n_dec)
        out[a] = float(measures.evaluate(delta, cont, gran.n_total))
    return out
