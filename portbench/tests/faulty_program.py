"""The program (``python -m pandepth_tpu_torch``) with one fault planted,
for the harness's tests: ``faulty_program.py <fault> <pandepth flags>``.

- ``none``: the program as it is;
- ``unchanged``: the step returns its state unchanged: exit 0 and no
  table written;
- ``half``: half of each sample left out: the program run with ``-q 11``
  added, which drops the reads of MAPQ 0 and 10, half of them;
- ``altered``: an answer altered where it is produced: the program's
  table with one number of its first row raised by one;
- ``exit``: the program fails: exit 3 after its run.

``--daemon-stop`` always reaches the program.
"""

import glob
import gzip
import subprocess
import sys


def main() -> int:
    fault, args = sys.argv[1], sys.argv[2:]
    prog = [sys.executable, "-m", "pandepth_tpu_torch"]
    if "--daemon-stop" in args or fault == "none":
        return subprocess.call(prog + args)
    if fault == "unchanged":
        return 0
    if fault == "half":
        return subprocess.call(prog + args + ["-q", "11"])
    rc = subprocess.call(prog + args)
    if fault == "exit":
        return 3
    prefix = args[args.index("-o") + 1]
    for path in glob.glob(prefix + ".*.stat.gz"):
        with gzip.open(path, "rb") as fh:
            lines = fh.read().split(b"\n")
        cols = lines[1].split(b"\t")
        k = 2 if lines[0].startswith(b"#Chr\tLength") else 5
        cols[k] = str(int(cols[k]) + 1).encode()  # CoveredSite
        lines[1] = b"\t".join(cols)
        with gzip.open(path, "wb") as fh:
            fh.write(b"\n".join(lines))
    return rc


if __name__ == "__main__":
    sys.exit(main())
