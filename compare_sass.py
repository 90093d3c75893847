"""Compares the SASS of the port's kernel library in two checkouts, function
by function, so that a change can show which kernels it left untouched:

    python3 compare_sass.py OTHER_CHECKOUT

builds both libraries from their sources (each checkout's
`sp_gan_tpu_torch/ops/kernels/_build.py`, one nvcc per source; an unchanged
library is loaded as it is), disassembles each with `cuobjdump -sass`,
drops the instruction addresses, the column padding (which follows the
widest instruction of the object) and the hash in each anonymous
namespace's name, and prints the functions that are identical, differ,
were added and are gone (OTHER_CHECKOUT is the "before" side), then one
JSON line. Needs nvcc and cuobjdump (the CUDA toolkit), no GPU.
"""

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join("sp_gan_tpu_torch", "ops", "kernels", "_build.py")


def load_build(root: str, name: str):
    """The `_build` module of the checkout at `root`."""
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(root, BUILD))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass(lib: str, cuobjdump: str) -> dict:
    """{function name: its SASS lines} of the library `lib`."""
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_[A-Za-z0-9_]+?_cu_"
                         r"[0-9a-f]+", "ANON", m.group(1))
            funcs[cur] = []
        elif cur:
            # the padding before each encoding comment follows the widest
            # instruction of the whole object, so it is dropped too
            funcs[cur].append(" ".join(
                re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split()))
    return funcs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the checkout to compare with (before)")
    args = ap.parse_args()
    builds = {"before": load_build(os.path.abspath(args.other), "before"),
              "after": load_build(HERE, "after")}
    libs = {}
    threads = [threading.Thread(target=lambda k=k, b=b: libs.__setitem__(
        k, str(b.build()))) for k, b in builds.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    nvcc = builds["after"].find_nvcc()
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc), "cuobjdump")
    a, b = (sass(libs[k], cuobjdump) for k in ("before", "after"))
    res = {"before": len(a), "after": len(b),
           "identical": sum(n in b and a[n] == b[n] for n in a),
           "differ": sorted(n for n in a if n in b and a[n] != b[n]),
           "added": sorted(n for n in b if n not in a),
           "gone": sorted(n for n in a if n not in b)}
    print(f"SASS: {res['before']} functions before, {res['after']} after; "
          f"{res['identical']} identical, {len(res['differ'])} differ, "
          f"{len(res['added'])} added, {len(res['gone'])} gone")
    for key in ("differ", "added", "gone"):
        for n in res[key]:
            print(f"  {key}: {n}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
