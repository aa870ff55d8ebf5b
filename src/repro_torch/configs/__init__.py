"""The ten architectures of the LM substrate: a copy of
:mod:`repro.configs` (the same ``CONFIG``/``SMOKE`` values and ``source``
strings), kept in the port so that it imports nothing of the JAX
package."""
from repro_torch.configs.registry import (ARCH_IDS, SHAPES, ArchConfig,
                                          ShapeConfig, all_cells,
                                          cell_is_runnable, get_arch,
                                          get_smoke)
