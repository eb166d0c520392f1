"""pandepth-compatible command line for the PyTorch port.

Flags are parsed by ``pandepth_tpu.cli.parse_args``; the run is
``pandepth_tpu_torch.run.run`` on a torch device. Usage::

    python -m pandepth_tpu_torch.cli -i x.bam -o out
"""

from __future__ import annotations

import sys
from typing import List, Optional

from pandepth_tpu.cli import parse_args


def resolve_device(device=None):
    """``None`` means ``cuda``, which must be present: there is no CPU
    fallback. Pass ``"cpu"`` explicitly to run the plain PyTorch twins."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pandepth_tpu_torch "
                           "runs on an NVIDIA GPU (pass device='cpu' to run "
                           "its plain PyTorch twins)")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"pandepth_tpu_torch runs on cuda or cpu, not "
                           f"{dev}")
    return dev


def main(argv: Optional[List[str]] = None, device=None) -> int:
    cfg = parse_args(argv if argv is not None else sys.argv)
    if cfg is None:
        return 0
    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    from pandepth_tpu_torch.run import run

    try:
        return run(cfg, dev)
    except OSError as e:
        print(f"Error: Failed to open the file: {e.filename or e}",
              file=sys.stderr)
        return 1
    except Exception as e:  # malformed inputs: clean error, no traceback
        import struct
        import zlib

        if isinstance(e, (ValueError, struct.error, zlib.error,
                          EOFError, IndexError, KeyError)):
            print(f"Error: malformed input: {e}", file=sys.stderr)
            return 1
        raise


if __name__ == "__main__":
    sys.exit(main())
