"""Phase 1 (the contig scan) and phase 2 (the native C++ feed and the Python
feed) of the port."""
