"""datagen.stream_share: the share of the trainer's batches made on the data maker's
own CUDA stream, in %: of the ``fusg.datagen`` spans outside the traced stretch, those
with a ``fusg.datagen.stream`` child (by ``parent_id``). A port without the record or
without datagen spans reads nothing; one without stream spans reads 0."""
from perfbench.harness import program_spans

BATCH = "fusg.datagen"
STREAM = "fusg.datagen.stream"


def read(run):
    spans = program_spans.record()
    if spans is None:
        return None
    window = program_spans.stretch(run.trace)
    on_stream = {s.parent_id for s in spans if s.name == STREAM}
    batches = [s.span_id in on_stream for s in spans if s.name == BATCH
               and not (window is not None and s.start_ns <= window[1]
                        and s.end_ns >= window[0])]
    return 100.0 * sum(batches) / len(batches) if batches else None
