"""The kernel build (``repro_torch.kernels.build``) when several processes
start on a fresh build directory at once, as the ranks of a mesh do: they
build the library once, and its objects are whole.

No card and no nvcc here: a fake ``nvcc`` on the PATH "compiles" a source
by copying it (slowly, so that two builds would overlap) and "links" by
concatenating the objects, logging every call.  Without the build's lock
both processes compiled into the same object paths and linked twice."""
import os
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

FAKE_NVCC = textwrap.dedent('''\
    #!{python}
    import sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    with open({log!r}, "a") as log:
        if "-shared" in args:
            objs = args[args.index("-o") + 2:]
            log.write("link\\n")
            with open(out, "w") as f:
                for o in objs:
                    f.write(open(o).read())
        else:
            src = args[args.index("-c") + 1]
            log.write("compile " + src + "\\n")
            time.sleep(0.5)
            with open(out, "w") as f:
                f.write("object of " + open(src).read() + "\\n")
    ''')

CALL_BUILD = textwrap.dedent('''\
    import sys
    from pathlib import Path
    from repro_torch.kernels import build
    build.CSRC, build.BUILD_DIR = Path(sys.argv[1]), Path(sys.argv[2])
    print(build.build())
    ''')


def test_concurrent_builds_build_once(tmp_path):
    csrc, out, bin_dir = tmp_path / "csrc", tmp_path / "build", \
        tmp_path / "bin"
    for d in (csrc, bin_dir):
        d.mkdir()
    sources = ["alpha", "beta", "gamma"]
    for name in sources:
        (csrc / f"{name}.cu").write_text(f"kernel {name}")
    (csrc / "common.cuh").write_text("header")
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=os.pathsep.join(
                   [str(Path(__file__).resolve().parents[1] / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen([sys.executable, "-c", CALL_BUILD, str(csrc),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    results = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), results
    libs = {stdout.strip() for stdout, _ in results}
    assert len(libs) == 1
    calls = log.read_text().splitlines()
    assert sorted(calls) == sorted(
        ["link"] + [f"compile {csrc / n}.cu" for n in sources]), calls
    lib = Path(libs.pop())
    assert lib.read_text() == "".join(f"object of kernel {n}\n"
                                      for n in sources)
    # this build's objects are gone; nothing half-written is left
    assert sorted(p.name for p in out.iterdir()) == sorted(
        ["build.log", "lock", lib.name])
