"""datagen.host_ms: median host time of one ``fusg.datagen`` span (one ``make_batch``
of the family's data source) outside the traced stretch."""
from perfbench.harness import program_spans


def read(run):
    return program_spans.median(run, "fusg.datagen")
