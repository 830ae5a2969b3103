"""Built-in twins of plugin task folders: ``<name>.py`` here is what
``model_folder: .../<name>`` loads when the folder has no ``task_torch.py``
(see :mod:`msrflute_tpu_torch.models.registry`)."""
