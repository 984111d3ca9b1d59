"""datagen.idle_ms: device idle time a step in the traced stretch whose gap began while
the host's innermost span was ``fusg.datagen`` or one of its children
(``fusg.datagen.draws`` / ``.views`` / ``.pairs``)."""


def _is_datagen(label: str) -> bool:
    return label == "fusg.datagen" or label.startswith("fusg.datagen.")


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    gaps = [s for label, s in t.idle_gaps if _is_datagen(label)]
    return 1e3 * sum(gaps) / t.units if gaps else None
