"""Chunk-config stream parsing (the port's copy of ``dict_fea_lab_arch``
and ``is_sequential`` from the JAX package's ``config/experiment.py``)."""

from __future__ import annotations

import configparser
import re
from typing import Dict

from .proto import ConfigError, strtobool


def dict_fea_lab_arch(config: configparser.ConfigParser):
    """From a *chunk* config, collect the feature/label/architecture specs
    actually used by the [model] section, in first-use order. Returns
    (fea_streams, lab_streams, arch_sections) where arch_sections maps
    arch_name -> section name."""
    from ..data.dataset import FeaStream, LabStream

    model_lines = config["model"]["model"].replace(" ", "").split("\n")
    fea_field = config["data_chunk"]["fea"]
    lab_field = config["data_chunk"]["lab"]
    fea_names = re.findall(r"fea_name=(.*)\n", fea_field.replace(" ", "") + "\n")
    lab_names = re.findall(r"lab_name=(.*)\n", lab_field.replace(" ", "") + "\n")
    arch_secs = {config[s]["arch_name"]: s for s in config.sections()
                 if "architecture" in s}

    def fea_block(name: str) -> "FeaStream":
        pat = (r"fea_name=" + re.escape(name) +
               r"\s*\n\s*fea_lst=(.*)\n\s*fea_opts=(.*)\n\s*cw_left=(.*)"
               r"\n\s*cw_right=(.*)")
        m = re.search(pat, fea_field + "\n")
        if not m:
            raise ConfigError("feature %r not found in data_chunk fea" % name)
        return FeaStream(name, m.group(1).strip(), m.group(2).strip(),
                         int(m.group(3)), int(m.group(4)))

    def lab_block(name: str) -> "LabStream":
        pat = (r"lab_name=" + re.escape(name) +
               r"\s*\n\s*lab_folder=(.*)\n\s*lab_opts=(.*)\n")
        m = re.search(pat, lab_field + "\n")
        if not m:
            raise ConfigError("label %r not found in data_chunk lab" % name)
        block = m.group(0) + lab_field[m.end():].split("lab_name=")[0]
        count = re.search(r"lab_count_file=(.*)", block)
        dataf = re.search(r"lab_data_folder=(.*)", block)
        graph = re.search(r"lab_graph=(.*)", block)
        return LabStream(name, m.group(1).strip(), m.group(2).strip(),
                         count.group(1).strip() if count else "auto",
                         dataf.group(1).strip() if dataf else "",
                         graph.group(1).strip() if graph else "")

    fea_used: Dict[str, "FeaStream"] = {}
    lab_used: Dict[str, "LabStream"] = {}
    arch_used: Dict[str, str] = {}
    pat3 = re.compile(r"(.+)=(\w+)\(([^,()]+),([^,()]+),([^,()]+)\)")
    pat2 = re.compile(r"(.+)=(\w+)\(([^,()]+),([^,()]+)\)")
    for line in model_lines:
        if not line:
            continue
        m = pat3.match(line) or pat2.match(line)
        if not m:
            raise ConfigError("bad model line %r" % line)
        for inp in list(m.groups())[2:]:
            if inp in fea_names and inp not in fea_used:
                fea_used[inp] = fea_block(inp)
            if inp in lab_names and inp not in lab_used:
                lab_used[inp] = lab_block(inp)
            if inp in arch_secs and inp not in arch_used:
                arch_used[inp] = arch_secs[inp]
    return list(fea_used.values()), list(lab_used.values()), arch_used


def is_sequential(config: configparser.ConfigParser,
                  arch_used: Dict[str, str]) -> bool:
    """True if any used architecture is sequential."""
    return any(strtobool(config[sec]["arch_seq_model"])
               for sec in arch_used.values())
