"""Program identity constants.

Mirrors the reference's globals (reference src/globals.rs:1-8), which derive the
version from git-describe at build time; here we keep a static version string plus a
best-effort git suffix resolved lazily by the CLI.
"""

PROGRAM_NAME = "portello-tpu"
PROGRAM_VERSION = "0.1.0"
