"""EARTH core (port of ``repro.core``): the plan compiler, shift networks,
shift-count generation, LSDO coalescing, step fusion, and the
row/column-accessible register-file layout."""
from repro_torch.core import lsdo, rcvrf, scg, shiftnet  # noqa: F401
