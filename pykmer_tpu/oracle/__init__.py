from .gold import (
    oracle_canonical_codes,
    oracle_canonical_codes_vec,
    oracle_count_stream,
    oracle_index_arrays,
    oracle_write_index,
    oracle_pair_counts,
)
