from repro_torch.data.pipeline import (ArraySource, DataSource, NpzShardSource,
                                       PrefetchIterator, as_source,
                                       write_npz_shards)
from repro_torch.data.synthetic import (PAPER_DATASETS, SyntheticSource,
                                        make_tabular, paper_dataset)
