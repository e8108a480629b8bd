"""Federated client data partitions for ADReSS / ADReSSo.

These hard-coded speaker lists are *dataset facts* defining the experiment
protocol (reference: federated/src/update.py:553-610): ADReSS training PAR
speakers split 50% "public" (global warm-start) + 25%/25% clients 0/1;
ADReSSo (unsupervised, Whisper pseudo-labels) split ~50/50 across clients.

A copy of ``privacy_preserve_federated_asr_tpu/data/splits.py`` (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Sequence

# ADReSS supervised splits (54 / 54 / 27 / 27 PAR speakers).
CLIENT_SPLITS_ADRESS: dict[str | int, tuple[str, ...]] = {
    "public": (
        "S086", "S021", "S018", "S156", "S016", "S077", "S027", "S116", "S143",
        "S082", "S039", "S150", "S004", "S126", "S137", "S097", "S128", "S059",
        "S096", "S081", "S135", "S094", "S070", "S049", "S080", "S040", "S076",
        "S093", "S141", "S034", "S056", "S090", "S130", "S092", "S055", "S019",
        "S154", "S017", "S114", "S100", "S036", "S029", "S127", "S073", "S089",
        "S051", "S005", "S151", "S003", "S033", "S007", "S084", "S043", "S009",
    ),  # 27 AD + 27 HC
    "public2": (
        "S058", "S030", "S064", "S104", "S048", "S118", "S122", "S001", "S087",
        "S013", "S025", "S083", "S067", "S068", "S111", "S028", "S015", "S108",
        "S095", "S002", "S072", "S020", "S148", "S144", "S110", "S124", "S129",
        "S071", "S136", "S140", "S145", "S032", "S101", "S103", "S139", "S038",
        "S153", "S035", "S011", "S132", "S006", "S149", "S041", "S079", "S107",
        "S063", "S061", "S125", "S062", "S012", "S138", "S024", "S052", "S142",
    ),  # 27 AD + 27 HC
    0: (
        "S058", "S030", "S064", "S104", "S048", "S118", "S122", "S001", "S087",
        "S013", "S025", "S083", "S067", "S068", "S111", "S028", "S015", "S108",
        "S095", "S002", "S072", "S020", "S148", "S144", "S110", "S124", "S129",
    ),  # 13 AD + 14 HC
    1: (
        "S071", "S136", "S140", "S145", "S032", "S101", "S103", "S139", "S038",
        "S153", "S035", "S011", "S132", "S006", "S149", "S041", "S079", "S107",
        "S063", "S061", "S125", "S062", "S012", "S138", "S024", "S052", "S142",
    ),  # 14 AD + 13 HC
}

# ADReSSo unsupervised splits (80 / 81 speakers).
CLIENT_SPLITS_ADRESSO: dict[int, tuple[str, ...]] = {
    0: (
        "adrso089", "adrso148", "adrso134", "adrso189", "adrso205", "adrso162",
        "adrso281", "adrso156", "adrso144", "adrso183", "adrso222", "adrso126",
        "adrso223", "adrso045", "adrso025", "adrso182", "adrso070", "adrso283",
        "adrso098", "adrso233", "adrso071", "adrso008", "adrso068", "adrso154",
        "adrso072", "adrso015", "adrso274", "adrso046", "adrso248", "adrso141",
        "adrso315", "adrso027", "adrso236", "adrso276", "adrso031", "adrso130",
        "adrso267", "adrso090", "adrso211", "adrso186", "adrso265", "adrso047",
        "adrso259", "adrso128", "adrso245", "adrso229", "adrso152", "adrso307",
        "adrso151", "adrso197", "adrso109", "adrso247", "adrso003", "adrso054",
        "adrso167", "adrso178", "adrso308", "adrso316", "adrso278", "adrso300",
        "adrso277", "adrso012", "adrso198", "adrso106", "adrso158", "adrso053",
        "adrso010", "adrso160", "adrso296", "adrso289", "adrso168", "adrso170",
        "adrso187", "adrso234", "adrso224", "adrso280", "adrso138", "adrso123",
        "adrso056", "adrso043",
    ),  # 43 AD + 37 HC
    1: (
        "adrso032", "adrso039", "adrso260", "adrso110", "adrso216", "adrso005",
        "adrso028", "adrso122", "adrso078", "adrso285", "adrso292", "adrso014",
        "adrso063", "adrso262", "adrso036", "adrso164", "adrso298", "adrso218",
        "adrso232", "adrso060", "adrso273", "adrso024", "adrso172", "adrso033",
        "adrso212", "adrso173", "adrso077", "adrso250", "adrso253", "adrso244",
        "adrso092", "adrso180", "adrso192", "adrso215", "adrso264", "adrso209",
        "adrso309", "adrso125", "adrso268", "adrso017", "adrso257", "adrso302",
        "adrso093", "adrso112", "adrso177", "adrso246", "adrso312", "adrso249",
        "adrso220", "adrso266", "adrso055", "adrso286", "adrso237", "adrso263",
        "adrso206", "adrso202", "adrso200", "adrso188", "adrso142", "adrso002",
        "adrso161", "adrso291", "adrso007", "adrso059", "adrso310", "adrso270",
        "adrso016", "adrso075", "adrso228", "adrso159", "adrso261", "adrso074",
        "adrso169", "adrso049", "adrso116", "adrso165", "adrso157", "adrso299",
        "adrso190", "adrso153", "adrso035",
    ),  # 44 AD + 37 HC
}


def filter_by_speakers(examples: Sequence, speakers: Sequence[str]) -> list:
    """Keep examples whose ``path`` starts with one of the speaker ids
    (reference: ``dataset.filter(path.startswith(tuple(client_spks)))``)."""
    prefixes = tuple(speakers)
    return [e for e in examples if e.path.startswith(prefixes)]
