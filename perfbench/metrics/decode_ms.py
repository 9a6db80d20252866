"""Device ms a call from the end of the network (a post-hook on the
predictor's model) to the end of the call: box decode and rotated NMS."""


def attach(run):
    run.spans.after('model_end', run.driver.layers()['model'])


def read(run):
    return (run.spans.between_ms('model_end', 'request_end')
            / run.window.requests)
