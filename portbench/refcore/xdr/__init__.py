"""XDR protocol layer: byte-exact codec + Stellar protocol types.

Reference: src/protocol-curr/xdr/*.x compiled by xdrpp (SURVEY.md §2.1); here
the types are declared directly in Python combinators (codec.py).
"""

from .codec import (Bool, FixedArray, Int32, Int64, Opaque, Optional, Uint32,
                    Uint64, VarArray, VarOpaque, Void, XdrError, XdrString,
                    deep_copy_value, pack, unpack, xdr_enum, xdr_struct,
                    xdr_union)
from .types import *      # noqa: F401,F403
from .contract import *        # noqa: F401,F403
from .ledger_entries import *  # noqa: F401,F403
from .transaction import *     # noqa: F401,F403
from .scp import *             # noqa: F401,F403
from .ledger import *          # noqa: F401,F403
