"""Phase 2 on the native C++ feed (phase 1 is shared with portello_tpu)."""
