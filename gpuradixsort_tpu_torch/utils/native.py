"""The native host runtime (``native/qehost.cpp``), shared with the JAX package.

``gpuradixsort_tpu.utils.native`` imports only numpy and ctypes (the JAX
package's ``__init__`` files are empty), so the port re-exports it as it is
and imports no JAX by doing so.
"""

from gpuradixsort_tpu.utils.native import (  # noqa: F401
    available,
    first_unsorted,
    radix_sort_pairs,
    random_keys,
    shuffled_permutation,
)
