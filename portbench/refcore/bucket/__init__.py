from .bucket import Bucket, entry_sort_key, merge_buckets
from .bucket_list import (NUM_LEVELS, BucketLevel, BucketList,
                          keep_tombstone_entries, level_half,
                          level_should_spill, level_size)
from .future import FutureBucket

__all__ = [
    "Bucket", "BucketLevel", "BucketList", "FutureBucket", "NUM_LEVELS",
    "entry_sort_key", "keep_tombstone_entries", "level_half",
    "level_should_spill", "level_size", "merge_buckets",
]
