from repro_torch.core.binning import (BinnedDataset, Binner, StreamingBinner,
                                      bin_dataset, dataset_from_codes)
from repro_torch.core.gbdt import (GBDTConfig, GBDTModel, TrainResult,
                                   goss_weights, train, train_streaming)
from repro_torch.core.losses import LOSSES, get_loss
from repro_torch.core.splits import SplitDecision, find_best_splits
from repro_torch.core.tree import (fit_forest, fit_forest_chunked, fit_tree,
                                   fit_tree_lossguide)
from repro_torch.kernels.ref import TreeArrays
