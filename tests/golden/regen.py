import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import re
from nmch.methods.fe import NMCH_FE
from nmch.methods.em import NMCH_EM
from nmch.params import HestonParams, SimConfig
import io, contextlib

for name, cls, kw in (("fe", NMCH_FE, {}), ("em", NMCH_EM, {})):
    m = cls(SimConfig(NTPB=512, NB=2, N=100), HestonParams(),
            engine="scan", **kw)
    m.init(1)
    m.compute()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m.print_stats()
    out = buf.getvalue()
    out = re.sub(r"^(Execution time ).*( ms)$", r"\1<TIME>\2", out, flags=re.M)
    out = re.sub(r"^(Initialization time ).*( ms)$", r"\1<TIME>\2", out, flags=re.M)
    with open(f"./print_stats_{name}.txt", "w") as f:
        f.write(out)
    print(name, "written")
