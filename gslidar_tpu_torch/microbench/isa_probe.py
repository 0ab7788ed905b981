"""Which packed bfloat16 instructions sm_90a offers the op chains.

    python -m gslidar_tpu_torch.microbench.isa_probe

On a machine with the CUDA toolkit, each instruction of ``PROBES`` is
assembled alone by ``ptxas -arch=sm_90a`` in a one-line kernel. For each
it prints whether ptxas takes it, its first error line if not, and the
SASS opcodes it became (``cuobjdump -sass``). It settles which packed
forms exist: ``microbench/bounds.py`` counts a MUFU op per element where
none does.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile

# name -> PTX body: %r0/%f0/%h0 hold the loaded word, the result goes to
# %r1/%f1/%h1, which is stored
PROBES = {
    "ex2.approx.ftz.bf16x2": "ex2.approx.ftz.bf16x2 %r1, %r0;",
    "rcp.approx.ftz.bf16x2": "rcp.approx.ftz.bf16x2 %r1, %r0;",
    "rsqrt.approx.ftz.bf16x2": "rsqrt.approx.ftz.bf16x2 %r1, %r0;",
    "rcp.approx.ftz.f32": "rcp.approx.ftz.f32 %f1, %f0;",
    "rsqrt.approx.ftz.f32": "rsqrt.approx.ftz.f32 %f1, %f0;",
    "ex2.approx.ftz.f32": "ex2.approx.ftz.f32 %f1, %f0;",
    "set.gt.u32.bf16x2": "set.gt.u32.bf16x2 %r1, %r0, %r0;",
    "cvt.rmi.bf16.bf16": "cvt.rmi.bf16.bf16 %h1, %h0;",
    "cvt.rmi.bf16x2.bf16x2": "cvt.rmi.bf16x2.bf16x2 %r1, %r0;",
    "cvt.rn.bf16x2.f32": "cvt.rn.bf16x2.f32 %r1, %f0, %f0;",
}

_PTX = """.version 8.0
.target sm_90a
.address_size 64
.visible .entry probe(.param .u64 p)
{{
  .reg .b16 %h<2>;
  .reg .b32 %r<3>;
  .reg .f32 %f<2>;
  .reg .b64 %rd<1>;
  ld.param.u64 %rd0, [p];
  ld.global.b32 %r0, [%rd0];
  mov.b32 %f0, %r0;
  cvt.u16.u32 %h0, %r0;
  mov.b32 %f1, %r0;
  mov.b32 %r1, %r0;
  mov.b16 %h1, %h0;
  {body}
  mov.b32 %r2, %f1;
  add.u32 %r1, %r1, %r2;
  cvt.u32.u16 %r2, %h1;
  add.u32 %r1, %r1, %r2;
  st.global.b32 [%rd0], %r1;
  ret;
}}
"""


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: the probes need the CUDA "
                           "toolkit")
    return path


def _opcodes(sass: str) -> list[str]:
    """The opcodes of the SASS lines (`/*0010*/  FFMA R1, ... ;`), with
    their modifiers, predicates dropped."""
    return re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", sass)


def ptx_probes() -> dict:
    """name -> {"ok": bool, "error": first ptxas error line or "",
    "sass": [opcodes of the probe's instruction and its neighbours]}."""
    ptxas, cuobjdump = _tool("ptxas"), _tool("cuobjdump")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, body in PROBES.items():
            ptx = os.path.join(tmp, "probe.ptx")
            cubin = os.path.join(tmp, "probe.cubin")
            with open(ptx, "w") as f:
                f.write(_PTX.format(body=body))
            p = subprocess.run([ptxas, "-arch=sm_90a", "-o", cubin, ptx],
                               capture_output=True, text=True)
            if p.returncode != 0:
                err = next((ln for ln in (p.stderr + p.stdout).splitlines()
                            if "error" in ln.lower()), p.stderr.strip())
                res[name] = dict(ok=False, error=err.strip(), sass=[])
                continue
            sass = subprocess.run([cuobjdump, "-sass", cubin],
                                  capture_output=True, text=True,
                                  check=True).stdout
            ops = [o for o in _opcodes(sass)
                   if not o.startswith(("LDG", "STG", "EXIT", "BRA", "NOP",
                                        "LDC", "ULDC", "MOV", "S2R",
                                        "IMAD.MOV", "IADD3", "LOP3", "PRMT",
                                        "SHF", "IMAD.U32"))]
            res[name] = dict(ok=True, error="", sass=ops)
    return res


def main():
    probes = ptx_probes()
    for name, r in probes.items():
        print(f"ptxas sm_90a {name:26s} "
              + ("ok  -> " + " ".join(r["sass"]) if r["ok"]
                 else f"REFUSED: {r['error']}"))
    return probes


if __name__ == "__main__":
    main()
