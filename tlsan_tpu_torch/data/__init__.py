"""The data pipeline: ETL (remap), builders, packers, native builder, cache."""

from tlsan_tpu_torch.data.remap import load_category, remap_ids, convert_raw_lines
from tlsan_tpu_torch.data.builders import (
    build_session_examples,
    build_prefix_examples,
    build_pairwise_examples,
    TIME_GAPS,
)
from tlsan_tpu_torch.data.batcher import (
    pack_session_train,
    pack_session_test,
    pack_prefix_train,
    pack_prefix_test,
    Batches,
    epoch_permutation,
)
