"""Tree SHA-1 of device-resident columns, the content key of a relation
on the card: ``sha1_tree`` holds the wrapper ``tree_tops`` and its plain
version ``tree_tops_plain``.  Port-only: the JAX package hashes on the
host.  The package attribute ``sha1_tree`` is the module."""
from . import sha1_tree  # noqa: F401
from .sha1_tree import tree_tops, tree_tops_plain  # noqa: F401
