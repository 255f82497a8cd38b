"""The fork's liver pipeline (counterpart of liverrenderer_tpu/pipeline/):
tissue volume fractions to the liver media's coefficients
(`prepare_medium`, `medium_models`), the LiverRenderer.py driver
(`driver`, with the settings reader `settings_yaml`), and the evaluation
of renders against goldens (`evaluate`, `results`, `substitute`)."""
