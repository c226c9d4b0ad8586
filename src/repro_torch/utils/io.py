"""Small I/O helpers shared by the dry run and the benchmark scripts.

``write_json_atomic`` exists so a run that times out (or crashes) can
never leave a truncated JSON record: the payload is serialized to a
sibling temp file first and ``os.replace``d into place, which is atomic
on POSIX — readers see either the old file or the complete new one,
never a partial write.
"""

import json
import os


def write_json_atomic(path, obj, *, indent=2, default=float):
    """Serialize ``obj`` as JSON to ``path`` via write-temp-then-rename."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent, default=default)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
