"""One driver a traffic kind (``"driver"`` in ``bench/traffic/<mix>.json``):
``bench/drivers/<kind>.py`` defines ``run(ctx) -> Outcome``."""
