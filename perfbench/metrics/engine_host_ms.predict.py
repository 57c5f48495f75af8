"""engine_host_ms.predict: the mean host time inside
``BayesEngine.predict`` a request (a harness span around the call, which
ends before the harness reads the outputs back), over the window's
requests."""


def read(run):
    r = run.record
    if r.kind != "predict" or not r.host_predict_s:
        return None
    return sum(r.host_predict_s) / len(r.host_predict_s) * 1e3
