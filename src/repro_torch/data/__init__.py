from repro_torch.data.synthetic import (PAPER_DATASETS, make_tabular,
                                        paper_dataset)
