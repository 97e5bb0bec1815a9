from shud_tpu_torch.io.tables import read_table, read_tables
from shud_tpu_torch.io.project import FilePaths, ProjectInput, load_project
