"""Build the native briskio extension in-place.

Usage: python native/build.py
Produces ethzasl_brisk_jax/_native/briskio*.so; core.image_io picks it up
automatically (pure-Python fallback otherwise).
"""
import os
import subprocess
import sys
import sysconfig

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
OUT_DIR = os.path.join(REPO, "ethzasl_brisk_jax", "_native")


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    open(os.path.join(OUT_DIR, "__init__.py"), "a").close()
    include = sysconfig.get_path("include")
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(OUT_DIR, "briskio" + ext)
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        f"-I{include}",
        os.path.join(HERE, "briskio.cc"),
        "-o", out,
        "-pthread",
    ]
    print(" ".join(cmd))
    subprocess.check_call(cmd)
    print("built", out)


if __name__ == "__main__":
    main()
