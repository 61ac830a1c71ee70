from .bucket import (Bucket, entry_sort_key, merge_buckets,
                     merge_buckets_raw)
from .bucket_list import (DEFAULT_RESIDENT_LEVELS, NUM_LEVELS, BucketLevel,
                          BucketList, keep_tombstone_entries, level_half,
                          level_should_spill, level_size)
from .future import FutureBucket
from .index import BucketIndex, DiskBucketIndex
from .manager import BucketDir, BucketListStore, BucketStreamWriter
from .snapshot import SearchableBucketListSnapshot

__all__ = [
    "Bucket", "BucketDir", "BucketIndex", "BucketLevel", "BucketList",
    "BucketListStore", "BucketStreamWriter", "DEFAULT_RESIDENT_LEVELS",
    "DiskBucketIndex", "FutureBucket", "NUM_LEVELS",
    "SearchableBucketListSnapshot",
    "entry_sort_key", "keep_tombstone_entries", "level_half",
    "level_should_spill", "level_size", "merge_buckets",
    "merge_buckets_raw",
]
