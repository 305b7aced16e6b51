"""mkrun: a run from a reference ``setups/*/setup.yml``, then its golden
check.

The port of ``fesom2_tpu/mkrun.py``.  The reference CI makes a work
directory with ``mkrun pi test_pi`` (the base namelists with the yaml's
overrides), runs it and compares the output fields' means with the goldens
of the yaml's ``fcheck`` block.  Here the base namelists
``$FESOM2_REF_ROOT/config/namelist.*`` are read by ``config.load_config``,
the yaml's ``namelist.*`` groups are applied on top, the run goes through
``run.run_pi`` (or ``run.run_soufflet`` for a toy channel) and
``post.fcheck.field_means`` gives the means.  The mesh and forcing ids of
the yaml are looked up in a paths file (``$FESOM2_TPU_PATHS``, the
``mkrun -m machine`` analog: ``mesh:`` and ``forcing:`` maps of id to
directory) over the defaults under the reference root.

    FESOM2_REF_ROOT=REF FESOM2_TPU_PATHS=paths.yml \\
        python -m fesom2_tpu_torch.mkrun setup.yml --result DIR \\
        [--steps N] [--rtol 0.05] [--f32] [--device cpu]

The setup and paths files are read by ``read_yaml``, a reader of the
YAML subset they use (block mappings, plain and quoted scalars, inline
lists) that resolves scalars as PyYAML's ``safe_load`` does and raises on
anything else: the card's machine has no PyYAML.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

from .config import ModelConfig, _apply, load_config, parse_namelist


# --------------------------------------------------------------------------
# the YAML subset
# --------------------------------------------------------------------------
# PyYAML's implicit resolvers (yaml/resolver.py) for the forms kept here;
# the YAML 1.1 forms outside the subset (octal, hex, binary and base-60
# numbers, digits with underscores, timestamps, merge keys) raise
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"),
                  ".INF": float("inf"), "+.inf": float("inf"),
                  "+.Inf": float("inf"), "+.INF": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"),
                  "-.INF": float("-inf"), ".nan": float("nan"),
                  ".NaN": float("nan"), ".NAN": float("nan")}
_OUTSIDE = re.compile(r"^(?:[-+]?0[0-7_]+|[-+]?0[xob]|[-+]?[0-9][0-9_]*"
                      r"(?::[0-5]?[0-9])+|[-+]?[0-9_.]*_[0-9_.]*|"
                      r"[0-9]{4}-[0-9]{1,2}-|<<$)")


class YamlSubsetError(ValueError):
    """A construct outside the subset ``read_yaml`` reads."""


def _plain_scalar(text: str, where: str):
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _OUTSIDE.match(text) or ": " in text or text.endswith(":"):
        raise YamlSubsetError(f"{where}: {text!r} is a YAML 1.1 form outside "
                              "the subset")
    if text[0] in "&*!|>%@`{}[]\"'?-," and not (
            text[0] == "-" and len(text) > 1 and text[1] != " "):
        raise YamlSubsetError(f"{where}: {text!r} starts with an indicator "
                              "outside the subset")
    return text


def _quoted(text: str, i: int, where: str):
    """(the string, index past its closing quote) of a quoted scalar
    starting at text[i]."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if j + 1 < len(text) and text[j + 1] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/"}
            if j + 1 >= len(text) or text[j + 1] not in esc:
                raise YamlSubsetError(f"{where}: escape outside the subset")
            out.append(esc[text[j + 1]])
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise YamlSubsetError(f"{where}: unterminated quoted scalar")


def _strip_comment(text: str) -> str:
    """The text before a comment (a ``#`` at the start or after a blank,
    outside quotes)."""
    q = None
    for i, c in enumerate(text):
        if q:
            if c == q:
                q = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[,:"):
            q = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _value(text: str, where: str):
    """A scalar or an inline list of scalars."""
    text = text.strip()
    if not text:
        return None
    if text[0] in "'\"":
        s, end = _quoted(text, 0, where)
        if text[end:].strip():
            raise YamlSubsetError(f"{where}: text after a quoted scalar")
        return s
    if text[0] == "[":
        if not text.endswith("]"):
            raise YamlSubsetError(f"{where}: an inline list spans lines")
        body = text[1:-1]
        items, i = [], 0
        while i < len(body):
            while i < len(body) and body[i] in " \t":
                i += 1
            if i >= len(body):
                break
            if body[i] in "'\"":
                s, i = _quoted(body, i, where)
                items.append(s)
            else:
                j = body.find(",", i)
                j = len(body) if j < 0 else j
                item = body[i:j].strip()
                if not item or item[0] in "[{":
                    raise YamlSubsetError(f"{where}: nested or empty "
                                          "inline-list item")
                items.append(_plain_scalar(item, where))
                i = j
            while i < len(body) and body[i] in " \t":
                i += 1
            if i < len(body):
                if body[i] != ",":
                    raise YamlSubsetError(f"{where}: bad inline list")
                i += 1
        return items
    return _plain_scalar(text, where)


def _split_key(body: str, where: str):
    """(key, rest of the line after 'key:')."""
    if body[0] in "'\"":
        key, end = _quoted(body, 0, where)
        rest = body[end:]
        if not rest.startswith(":") or (len(rest) > 1 and rest[1] != " "):
            raise YamlSubsetError(f"{where}: a quoted key without ': '")
        return key, rest[1:]
    m = re.match(r"^(.*?):(?: |$)", body)
    if not m:
        raise YamlSubsetError(f"{where}: not a 'key: value' line")
    return _plain_scalar(m.group(1).rstrip(), where), body[m.end():]


def parse_yaml(text: str, name: str = "<yaml>"):
    """The mapping of a YAML text in the subset (``read_yaml``)."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"{where}: a tab in the indentation")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if raw.startswith(("---", "...", "%")):
            raise YamlSubsetError(f"{where}: documents and directives are "
                                  "outside the subset")
        indent = len(body) - len(body.lstrip(" "))
        body = body.strip()
        if body.startswith(("- ", "? ")) or body in ("-", "?"):
            raise YamlSubsetError(f"{where}: block sequences and complex "
                                  "keys are outside the subset")
        lines.append((indent, body, where))
    if not lines:
        return None
    root, pos = _mapping(lines, 0, lines[0][0])
    if pos != len(lines):
        raise YamlSubsetError(f"{lines[pos][2]}: indentation does not match "
                              "an enclosing mapping")
    return root


def _mapping(lines, pos, indent):
    out = {}
    while pos < len(lines):
        ind, body, where = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise YamlSubsetError(f"{where}: unexpected indentation")
        key, rest = _split_key(body, where)
        rest = rest.strip()
        pos += 1
        if rest:
            out[key] = _value(rest, where)
        elif pos < len(lines) and lines[pos][0] > indent:
            out[key], pos = _mapping(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos


def read_yaml(path: str):
    """Read a setup or paths file (the YAML subset above) as nested dicts;
    raises ``YamlSubsetError`` on a construct outside the subset."""
    with open(path) as f:
        return parse_yaml(f.read(), path)


# --------------------------------------------------------------------------
# the setup
# --------------------------------------------------------------------------
def _ref_root() -> str:
    return os.environ.get("FESOM2_REF_ROOT", "/root/reference")


def _machine_paths():
    """The mesh and forcing id -> directory maps: the paths file
    ``$FESOM2_TPU_PATHS`` (``mesh:`` and ``forcing:`` maps) over the test
    data under the reference root."""
    ref = _ref_root()
    mesh = {"test_global": os.path.join(ref, "test/meshes/pi"),
            "test_souf": os.path.join(ref, "test/meshes/soufflet")}
    forcing = {"test_global": os.path.join(ref, "test/input/global")}
    pf = os.environ.get("FESOM2_TPU_PATHS")
    if pf and os.path.exists(pf):
        y = read_yaml(pf) or {}
        mesh.update(y.get("mesh", {}) or {})
        forcing.update(y.get("forcing", {}) or {})
    return mesh, forcing


# yaml namelist group -> ModelConfig sub-dataclass attribute path(s)
_GROUP_TARGETS = {
    "timestep": ("timestep",),
    "clockinit": ("clock",),
    "calendar": ("clock",),
    "ale_def": ("ale",),
    "geometry": ("geometry",),
    "run_config": ("run",),
    "restart_log": (None,),          # top-level fields on ModelConfig
    "inout": (None,),
    "oce_dyn": ("dyn", "tra"),
    "oce_tra": ("tra", "dyn"),
    "ice_dyn": ("ice",),
    "ice_therm": ("ice",),
    "ice_stress": ("ice",),
    "nam_sbc": ("sbc",),
}


# reference namelist.icepack key -> IcepackConfig field.  env_nml uses the
# icepack.settings names (nicecat..., trage as 0/1 ints,
# config/namelist.icepack:1-24); tracer_nml the tr_* logicals (:30-39)
_ICEPACK_KEYS = {
    "nicecat": "ncat", "nicelyr": "nilyr", "nsnwlyr": "nslyr",
    "trage": "tr_iage", "trfy": "tr_FY", "trlvl": "tr_lvl",
    "trpnd": "tr_pond_cesm", "trbgcs": "tr_bgc",
    "tr_iage": "tr_iage", "tr_fy": "tr_FY", "tr_lvl": "tr_lvl",
    "tr_pond_cesm": "tr_pond_cesm", "tr_fsd": "tr_fsd",
    "kcatbound": "kcatbound",
    "kitd": "kitd", "ktherm": "ktherm", "conduct": "conduct",
    "ksno": "ksno",
    "shortwave": "shortwave", "albicev": "albicev", "albicei": "albicei",
    "albsnowv": "albsnowv", "albsnowi": "albsnowi", "albocn": "albocn",
    "ahmax": "ahmax", "dt_mlt": "dT_mlt",
    "rfracmin": "rfracmin", "rfracmax": "rfracmax",
    "pndaspect": "pndaspect",
    "kstrength": "kstrength", "krdg_partic": "krdg_partic",
    "krdg_redist": "krdg_redist", "mu_rdg": "mu_rdg", "cf": "Cf",
    "ndtd": "ndtd",
}
_ICEPACK_BOOL = {"tr_iage", "tr_FY", "tr_lvl", "tr_pond_cesm", "tr_bgc",
                 "tr_fsd"}


def icepack_opts_from_nml(groups: dict) -> dict:
    """Flatten parsed namelist.icepack groups into IcepackConfig keywords
    (``fesom2_tpu/mkrun.py:97-115``)."""
    opts = {}
    for items in groups.values():
        if not isinstance(items, dict):
            continue
        for key, val in items.items():
            field = _ICEPACK_KEYS.get(key.lower())
            if field is None:
                continue
            if field in _ICEPACK_BOOL:
                val = bool(val)
            opts[field] = val
    # nfsdcat > 1 switches the FSD tracer on (env_nml analog of tr_fsd)
    for items in groups.values():
        if isinstance(items, dict) and int(items.get("nfsdcat", 1) or 1) > 1:
            opts["tr_fsd"] = True
            opts["nfsd"] = int(items["nfsdcat"])
    return opts


def load_setup(setup_yml: str):
    """A reference setup.yml as (cfg, mesh path, forcing path or None,
    goldens, Icepack options or None, io_list), as
    ``fesom2_tpu/mkrun.py:118-177`` reads it: the base namelists of the
    reference root with the yaml's groups applied on top, the Icepack
    options where the yaml has a ``namelist.icepack`` section, the
    ``namelist.io`` stream list (the yaml's ``io_list`` replaces it
    wholesale) and ``diag_list``."""
    from .io.streams import parse_namelist_io
    y = read_yaml(setup_yml) or {}
    ref = _ref_root()
    cfg = load_config(os.path.join(ref, "config/namelist.config"),
                      os.path.join(ref, "config/namelist.oce"),
                      os.path.join(ref, "config/namelist.ice"),
                      os.path.join(ref, "config/namelist.forcing"))

    ipk_opts = None
    if "namelist.icepack" in y:
        base = os.path.join(ref, "config/namelist.icepack")
        groups = parse_namelist(base) if os.path.exists(base) else {}
        for gname, items in (y.get("namelist.icepack") or {}).items():
            if isinstance(items, dict) and gname.lower() != "nml_list_icepack":
                groups.setdefault(gname.lower(), {}).update(items)
        ipk_opts = icepack_opts_from_nml(groups)
    for nml in ("namelist.config", "namelist.oce", "namelist.ice",
                "namelist.forcing"):
        for gname, items in (y.get(nml) or {}).items():
            targets = _GROUP_TARGETS.get(gname.lower())
            if targets is None or not isinstance(items, dict):
                continue
            for t in targets:
                _apply(cfg if t is None else getattr(cfg, t), items)

    io_nml = os.path.join(ref, "config/namelist.io")
    io_list = parse_namelist_io(io_nml) if os.path.exists(io_nml) else []
    y_io = (y.get("namelist.io") or {}).get("nml_list") or {}
    if isinstance(y_io.get("io_list"), dict):
        io_list = [(sid.strip(), int(spec.get("freq", 1)),
                    str(spec.get("unit", "d")),
                    "f4" if int(spec.get("prec", 8)) == 4 else "f8")
                   for sid, spec in y_io["io_list"].items()]
    for gname, items in (y.get("namelist.io") or {}).items():
        if gname.lower() == "diag_list" and isinstance(items, dict):
            _apply(cfg.diag, items)

    mesh_key = y.get("mesh", "test_global")
    forcing_key = y.get("forcing", "test_global")
    goldens = y.get("fcheck", {}) or {}
    mesh_paths, forcing_paths = _machine_paths()
    if mesh_key not in mesh_paths:
        raise KeyError(
            f"mesh id '{mesh_key}' not in the paths map; provide it via a "
            f"FESOM2_TPU_PATHS yaml (mesh: {{{mesh_key}: /path}})")
    return (cfg, mesh_paths[mesh_key], forcing_paths.get(forcing_key),
            goldens, ipk_opts, io_list)


def _run_length_steps(cfg: ModelConfig) -> int:
    """The steps of the configuration's run length."""
    n = cfg.timestep.run_length
    unit = cfg.timestep.run_length_unit
    spd = cfg.timestep.step_per_day
    days = {"d": 1, "m": 31, "y": 365}.get(unit, 1) * n
    if unit == "s":
        return max(1, int(n / (86400.0 / spd)))
    return days * spd


def check_goldens(means: dict, goldens: dict, rtol: float):
    """(verdict, report lines): every golden has a mean within ``rtol``
    of it, relative to max(|golden|, 1e-3)."""
    ok = True
    report = []
    for name, gold in goldens.items():
        if name not in means:
            report.append(f"MISSING {name} (golden {gold})")
            ok = False
            continue
        got = means[name]
        rel = abs(got - gold) / max(abs(gold), 1e-3)
        good = rel <= rtol
        ok = ok and good
        report.append(f"{'OK  ' if good else 'FAIL'} {name}: got {got:.9g} "
                      f"golden {gold:.9g} rel {rel:.2e}")
    return ok, report


def run_setup(setup_yml: str, result_path: str, steps: Optional[int] = None,
              *, device="cuda", dtype=torch.float64, verbose: bool = True,
              rtol: float = 0.05):
    """Build and run a reference setup on ``device``; returns (ok, means,
    goldens).  ``ok`` is the golden check at relative tolerance ``rtol``
    (5% by default: an independent implementation held to the Fortran
    reference's CI means).  A pi setup starts from ``pi_initial_state``
    with the forcing directory's WOA file where there is a forcing path."""
    from .io.streams import streams_from_io_list
    from .model import pi_initial_state, setup_pi_model, setup_soufflet_model
    from .post.fcheck import field_means
    from .run import run_pi, run_soufflet

    (cfg, mesh_path, forcing_path, goldens, ipk_opts,
     io_list) = load_setup(setup_yml)
    n_steps = steps if steps is not None else _run_length_steps(cfg)
    os.makedirs(result_path, exist_ok=True)
    if cfg.run.toy_ocean:
        model = setup_soufflet_model(mesh_path, device=device, dtype=dtype,
                                     cfg=cfg)
        run_soufflet(n_steps, device=device, dtype=dtype, verbose=verbose,
                     model=model, result_path=result_path)
    else:
        model, atm = setup_pi_model(mesh_path, device=device, dtype=dtype,
                                    cfg=cfg, forcing_path=forcing_path)
        state, ice = pi_initial_state(model, forcing_path=forcing_path)
        stream_defs = streams_from_io_list(io_list, model.mesh, model.cfg,
                                           atm=atm) if io_list else None
        run_pi(model, atm, state, ice, n_steps, verbose=verbose,
               use_icepack=ipk_opts is not None, icepack_opts=ipk_opts,
               result_path=result_path, stream_defs=stream_defs)
    means = field_means(result_path)
    ok, report = check_goldens(means, goldens, rtol)
    if verbose:
        print("\n".join(report), flush=True)
    return ok, means, goldens


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="mkrun + fcheck from a reference "
                                            "setup.yml")
    p.add_argument("setup_yml")
    p.add_argument("--result", default="./work")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--rtol", type=float, default=0.05)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU only when asked)")
    args = p.parse_args(argv)
    dtype = torch.float32 if args.f32 else torch.float64
    ok, _, _ = run_setup(args.setup_yml, args.result, steps=args.steps,
                         device=args.device, dtype=dtype, rtol=args.rtol)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
